"""ffn_device_share: the union of the device operations' intervals placed
in the port's ``layer.ffn`` spans (norm2, the MLP or the MoE with its
routing, dispatch and combine, the residual add) over the traced
batches' busy time, in % (``bench.spans``)."""
from bench import spans


def read(ctx):
    placed = spans.place(ctx.trace)
    if placed is None:
        return None
    return 100.0 * placed.union_s("layer.ffn") / ctx.trace.busy_s
