"""ffn_gemm_share: of the device time placed in the port's ``layer.ffn``
spans (``bench.spans``), the share in matrix-product kernels, in %. The
rest is norm2, the residual add and, in a MoE, its routing, dispatch,
combine and casts. ``KERNELS``: on the H100 both cells' products run as
cuBLAS's ``nvjet_*`` kernels and cuBLASLt's ``splitKreduce_kernel``;
``gemm``, ``gemv``, ``xmma`` and ``cutlass`` name cuBLAS's other product
kernels, which another shape may pick."""
from bench import spans

KERNELS = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "splitKreduce")


def read(ctx):
    placed = spans.place(ctx.trace)
    if placed is None:
        return None
    ops = placed.within("layer.ffn")
    total = sum(e - s for _, s, e, _, _ in ops)
    if not total:
        return None
    gemm = sum(e - s for name, s, e, _, _ in ops
               if any(k in name for k in KERNELS))
    return 100.0 * gemm / total
