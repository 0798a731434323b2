"""flash_roofline: B3's least time (the arch's ``batch_work``
``flash_bound_s``, the causal attention's FLOPs or its q, k, v and o
bytes at the H100's peaks) over the device time of B3's kernels, in the
traced batches, in %."""
KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.device_s(KERNELS)
    if not t:
        return None
    batches = len(tr.of("bench.batch"))
    return 100.0 * batches * ctx.work.flash_bound_s() / t
