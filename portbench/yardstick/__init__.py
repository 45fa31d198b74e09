"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move it: the profiler window and the busy-interval union
(``trace``), the chip's peaks (``peaks``), FLOP and byte counts
(``counts``) and the synthetic training tokens (``tokens``).  The seeded
weights are the reference's (``reference/moe_lm.py``)."""
