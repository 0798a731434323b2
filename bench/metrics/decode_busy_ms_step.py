"""decode_busy_ms_step: the union of the device operations' intervals
placed in the port's ``serve.step`` spans (``bench.spans``), over the
traced batches' steps, in ms: the device's time for one decode step."""
from bench import spans


def read(ctx):
    placed = spans.place(ctx.trace)
    if placed is None:
        return None
    steps = len(spans.program_spans(ctx.trace, "serve.step"))
    busy = placed.union_s("serve.step")
    return 1e3 * busy / steps if steps and busy else None
