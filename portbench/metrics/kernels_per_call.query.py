"""Kernels the device ran in the traced window per stacked query call."""
from portbench.metrics import per


def read(ctx):
    return per(ctx, "calls")
