"""score_mfu: the model FLOPs of every batch of the window (the arch's
``batch_work`` ``model_flops``: counted from the configuration's shapes)
over the window's span times the H100's bf16 peak, in %: the whole
sweep's share of the chip's peak."""
from bench.work import PEAK_BF16_FLOPS


def read(ctx):
    flops = len(ctx.batches) * ctx.work.model_flops()
    return 100.0 * flops / (ctx.window_s * PEAK_BF16_FLOPS)
