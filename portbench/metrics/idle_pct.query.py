"""The device's idle share of the traced window of query calls, %."""
from portbench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
