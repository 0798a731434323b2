"""decode_ms_step: all the window's time in ``serve_steps`` (decode steps
and their scoring) over all its steps, in ms; the harness's spans,
synchronised at their ends."""


def read(ctx):
    spans = [b.decode_end - b.prefill_end for b in ctx.batches
             if b.decode_end is not None]
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * ctx.traffic.scored_steps)
