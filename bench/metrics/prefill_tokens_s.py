"""prefill_tokens_s: all prompt tokens of the window over all its prefill
time, each prefill timed by the harness's span around ``Model.prefill``
(synchronised at its end)."""


def read(ctx):
    spans = [b.prefill_end - b.start for b in ctx.batches
             if b.prefill_end is not None]
    if not spans:
        return None
    t = ctx.traffic
    return len(spans) * t.batch * t.prompt_len / sum(spans)
