"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at the
700 W limit).  A share of a peak is stated against these, with the
card's power limit beside it."""

#: bf16 / fp16 tensor-core FLOP/s, dense
BF16_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BYTES_S = 3.35e12
