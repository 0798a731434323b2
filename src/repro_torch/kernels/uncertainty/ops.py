"""Wrapper for fused uncertainty scoring (port of
repro/kernels/uncertainty/ops.py).

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (``csrc/uncertainty_stats.cu``) or raises; a CPU tensor takes the
plain version in ``ref``. ``impl="ref"`` forces the plain version on any
device, so the kernel can be timed against it on the card; the serving
path never passes it. ``LAUNCHES`` counts kernel launches, one per call
that reaches the card (the split pass and the merge pass of one call count
once).

The kernel splits each row's V logits into ``split_plan(...).splits``
contiguous shares, one CTA each, and merges their partial statistics in
split order; ``ref.uncertainty_stats_split_ref`` is that arithmetic in
plain PyTorch. It agrees with the plain version within the reference's
tolerances.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import launches
from repro_torch.kernels.uncertainty import ref

KINDS = ("lc", "mc", "rc", "es")

LAUNCHES = {"uncertainty_stats": 0}

# the C entry's code for each input dtype it reads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    launches.reset(LAUNCHES)


_FN = []

# Logits a split CTA reads, by dtype (split_elems<T>() in
# csrc/uncertainty_stats.cu: 256 threads x 8 units x 16 bytes).
SPLIT_ELEMS = {torch.float32: 8_192, torch.bfloat16: 16_384,
               torch.float16: 16_384}


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The kernel's grid for (n, V) logits of one dtype: ``splits`` CTAs a
    row, each over ``split_elems`` contiguous logits (the last one ragged),
    ``ctas`` in all. ``splits`` and ``split_elems`` depend on V and the
    dtype alone, never on n, so a row's scores are the same bits alone or
    among any others."""
    splits: int
    split_elems: int
    ctas: int


def split_plan(n: int, v: int, dtype) -> SplitPlan:
    elems = SPLIT_ELEMS[dtype]
    splits = -(-int(v) // elems)
    return SplitPlan(splits, elems, int(n) * splits)


def _lib():
    if not _FN:
        from repro_torch.kernels import build
        lib = build.load("uncertainty_stats")
        fn = lib.uncertainty_stats
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, p]
        fn.restype = i
        elems = lib.uncertainty_stats_split_elems
        elems.argtypes = [i]
        elems.restype = i
        for dtype, code in _DTYPES.items():
            if elems(code) != SPLIT_ELEMS[dtype]:
                raise RuntimeError(f"uncertainty_stats splits {dtype} rows "
                                   f"every {elems(code)} logits, the "
                                   f"wrapper every {SPLIT_ELEMS[dtype]}")
        _FN.append(fn)
    return _FN[0]


def _stats_cuda(logits: torch.Tensor) -> torch.Tensor:
    """(N, V) logits on the card -> (4, N) fp32 [lc, mc, rc, es]."""
    if logits.dim() != 2:
        raise ValueError(f"expected (N, V) logits, got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"the uncertainty_stats kernel reads float32, "
                         f"bfloat16 or float16 logits, not {logits.dtype}")
    N, V = logits.shape
    if V < 1:
        raise ValueError("logits need at least one column")
    x = logits.contiguous()
    splits = split_plan(N, V, x.dtype).splits
    # out (4, N), then the split pass's (N, S) partials of 4 floats
    buf = torch.empty((4 * N * (1 + splits),), dtype=torch.float32,
                      device=x.device)
    out = buf[:4 * N].view(4, N)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    base = buf.data_ptr()
    err = _lib()(x.data_ptr(), _DTYPES[x.dtype], base, base + 16 * N, N, V,
                 stream)
    if err != 0:
        raise RuntimeError(f"uncertainty_stats kernel launch failed: CUDA "
                           f"error {err}")
    launches.bump(LAUNCHES, "uncertainty_stats")
    return out


def _use_kernel(logits: torch.Tensor, impl: str) -> bool:
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    launches.refuse_dtensor(logits)
    if logits.device.type == "cpu":
        return False
    if logits.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {logits.device}")
    return True


def uncertainty_stats(logits, impl: str = "auto"):
    """All four scores in one pass: dict of (N,) fp32 (higher = more
    informative)."""
    if not _use_kernel(logits, impl):
        return ref.uncertainty_stats_ref(logits)
    stats = _stats_cuda(logits)
    return {k: stats[i] for i, k in enumerate(KINDS)}


def uncertainty_scores(logits, kind: str = "lc", impl: str = "auto"):
    """logits: (N, V) -> (N,) fp32 scores of one ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return uncertainty_stats(logits, impl)[kind]
