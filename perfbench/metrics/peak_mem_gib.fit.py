"""Device: the most memory the program held on the card over the untraced
window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    return ctx.peak_window_bytes / 2**30 if ctx.peak_window_bytes else None
