"""decode_host_ms_step: the mean host duration of the port's
``serve.step`` spans in the traced batches, in ms: the host's time to
issue one decode step (the token pick, ``Model.decode_step`` and the
scores), in which nothing waits for the device."""
from bench import spans


def read(ctx):
    steps = spans.program_spans(ctx.trace, "serve.step")
    if not steps:
        return None
    return sum(r.end_ns - r.start_ns for r in steps) / len(steps) / 1e6
