"""The whole stacked call's share of the chip's bandwidth, %: the least
bytes a stacked query call needs (``yardstick/counts.py::fd_call_bytes``)
times the calls, at 3.35 TB/s, over the traced window.  The same work
whatever implements it."""
from portbench.yardstick.counts import fd_call_bytes
from portbench.yardstick.peaks import HBM_BYTES_S


def read(ctx):
    c = ctx["counts"]
    if "calls" not in c or ctx["window_s"] <= 0:
        return None
    need = c["calls"] * fd_call_bytes(c["queries"],
                                      c["peers"] * c["items_per_peer"],
                                      c["k"])
    return 100.0 * need / HBM_BYTES_S / ctx["window_s"]
