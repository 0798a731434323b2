"""decode_attn_roofline: B6's least time (the arch's ``batch_work``
``decode_attn_bound_s``, the live K/V, q and output bytes at the H100's
HBM peak) over the device time of B6's split and merge kernels, in the
traced batches, in %."""
KERNELS = ("decode_attention_split_kernel", "decode_attention_merge_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.device_s(KERNELS)
    if not t:
        return None
    batches = len(tr.of("bench.batch"))
    return 100.0 * batches * ctx.work.decode_attn_bound_s() / t
