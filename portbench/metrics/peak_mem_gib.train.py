"""The allocator's peak over the traced training steps
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
GiB."""


def read(ctx):
    b = ctx["counts"].get("peak_window_bytes")
    return b / 2 ** 30 if b else None
