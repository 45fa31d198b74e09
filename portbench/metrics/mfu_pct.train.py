"""The whole training step's share of the chip's bf16 peak, %: model
FLOPs (``yardstick/counts.py::train_flops_per_token``, from the
configuration and the tokens) of the traced steps over the traced
window, against 989 TFLOP/s."""
from portbench.yardstick.peaks import BF16_FLOPS


def read(ctx):
    c = ctx["counts"]
    if "steps" not in c or ctx["window_s"] <= 0:
        return None
    flops = c["steps"] * c["tokens_per_step"] * c["flops_per_token"]
    return 100.0 * flops / ctx["window_s"] / BF16_FLOPS
