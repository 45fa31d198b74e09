"""The per-peer top-k kernels' share of their roofline, %: the bytes the
query shapes need (``yardstick/counts.py::topk_bytes``, every score read
once, each peer's k-list written once) at 3.35 TB/s, over the summed
device time of the port's top-k kernels (``topk_*`` and ``sel_*`` of
``kernels/csrc/topk.cu`` and ``topk_select.cu``).  Silent where no such
kernel ran."""
from portbench.metrics import named_us
from portbench.yardstick.counts import topk_bytes
from portbench.yardstick.peaks import HBM_BYTES_S


def read(ctx):
    c = ctx["counts"]
    us = named_us(ctx, ("topk_", "sel_"))
    if not us or "calls" not in c:
        return None
    need = c["calls"] * topk_bytes(c["queries"], c["peers"],
                                   c["items_per_peer"], c["k"])
    return 100.0 * need / HBM_BYTES_S / (us / 1e6)
