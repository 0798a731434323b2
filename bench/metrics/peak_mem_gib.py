"""peak_mem_gib: the device's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), read before the check runs."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2 ** 30
