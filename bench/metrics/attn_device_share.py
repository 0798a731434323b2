"""attn_device_share: the union of the device operations' intervals placed
in the port's ``layer.mixer`` spans (norm1, the attention, its residual
add) over the traced batches' busy time, in % (``bench.spans``)."""
from bench import spans


def read(ctx):
    placed = spans.place(ctx.trace)
    if placed is None:
        return None
    return 100.0 * placed.union_s("layer.mixer") / ctx.trace.busy_s
