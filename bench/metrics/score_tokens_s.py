"""score_tokens_s: every prompt and scored token of every batch of the
window, over the window's whole span (its first batch's start to its last
batch's completion); host clock."""


def read(ctx):
    return len(ctx.batches) * ctx.traffic.tokens_per_batch / ctx.window_s
