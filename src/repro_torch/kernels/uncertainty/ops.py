"""Wrapper for fused uncertainty scoring (port of
repro/kernels/uncertainty/ops.py).

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (``csrc/uncertainty_stats.cu``) or raises; a CPU tensor takes the
plain version in ``ref``. ``impl="ref"`` forces the plain version on any
device, so the kernel can be timed against it on the card; the serving
path never passes it. ``LAUNCHES`` counts kernel launches, one per call
that reaches the card.
"""
from __future__ import annotations

import ctypes

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


def _lib():
    if not _FN:
        from repro_torch.kernels import build
        fn = build.load("uncertainty_stats").uncertainty_stats
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, i, p]
        fn.restype = i
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
    out = torch.empty((4, N), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), _DTYPES[x.dtype], out.data_ptr(), N, V,
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
