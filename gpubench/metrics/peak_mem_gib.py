"""peak_mem_gib: the program's peak allocated device memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(ctx):
    return ctx.window_peak_bytes / 2**30 if ctx.window_peak_bytes else None
