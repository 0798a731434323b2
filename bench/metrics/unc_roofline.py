"""unc_roofline: B4's least time (the arch's ``batch_work``
``unc_bound_s``, the fp32 logits read once and the scores written, at
the H100's HBM peak) over the device time of B4's split and merge
kernels, in the traced batches, in %."""
KERNELS = ("uncertainty_stats_split_kernel", "uncertainty_stats_merge_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.device_s(KERNELS)
    if not t:
        return None
    batches = len(tr.of("bench.batch"))
    return 100.0 * batches * ctx.work.unc_bound_s() / t
