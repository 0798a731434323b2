"""decode_kernels_step: device kernels that start inside the traced
batches' decode spans, over their steps (torch.profiler)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    steps = len(tr.of("bench.decode")) * ctx.traffic.scored_steps
    n = len(tr.ops_in("bench.decode", kinds=("kernel",)))
    return n / steps if steps and n else None
