"""Kernels the device ran in the traced window per training step."""
from portbench.metrics import per


def read(ctx):
    return per(ctx, "steps")
