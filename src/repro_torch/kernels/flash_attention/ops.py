"""Wrapper for the flash-attention forward kernel (port of
repro/kernels/flash_attention/ops.py).

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (``csrc/flash_attention.cu``) or raises; a CPU tensor takes the
plain chunked path with ``q_chunk`` and ``kv_chunk``, as the reference
does off the TPU. ``impl="ref"`` takes the naive plain version on any
device, so the kernel can be timed against it on the card; the serving
path never passes it.

The kernel's KV tile is ``kv_chunk`` (clamped to Skv), the grid the
chunked path and the reference's interpret lane use. The reference's own
kernel branch drops ``kv_chunk`` and takes its default of 128; the port
passes it, so a row's online-softmax trajectory is the chunked path's.
The kernel computes in fp32: bf16 inputs are cast up for it and its
output is cast back, so every path returns ``q.dtype``, as the chunked
path and the reference's kernel do.
``LAUNCHES`` counts kernel launches, one per call that reaches the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0}

# the C entry's answer to a shape it does not take (head_dim > 256, or a
# shared-memory carve larger than the card allows)
_CUDA_ERROR_INVALID_VALUE = 1


def reset_launches() -> None:
    launches.reset(LAUNCHES)


_FN = []


def _lib():
    if not _FN:
        from repro_torch.kernels import build
        fn = build.load("flash_attention").flash_attention_fwd_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
        _FN.append(fn)
    return _FN[0]


def _flash_cuda(q, k, v, *, causal: bool, window: Optional[int],
                scale: float, kv_block: int):
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must lie on one device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,D) and k, v (B,Skv,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    kb = max(1, min(int(kv_block), Skv))
    dtype = q.dtype
    q, k, v = (t.to(torch.float32).contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out.to(dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, KH, D, kb, int(causal),
                 0 if window is None else int(window), float(scale), stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the flash_attention kernel does not take head_dim "
                         f"{D} at kv_block {kb} (head_dim <= 256, and the "
                         f"block's shared-memory tiles must fit the card)")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches.bump(LAUNCHES, "flash_attention")
    return out.to(dtype)


def flash_attention_auto(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None, q_chunk: int = 512,
                         kv_chunk: int = 1024, impl: str = "auto"):
    """q: (B,Sq,H,D); k,v: (B,Skv,KH,D) -> (B,Sq,H,D), causal and optional
    sliding-window masks, GQA. A row's result depends on ``kv_chunk`` and
    never on ``q_chunk`` or Sq."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if impl == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        from repro_torch.models.layers.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    return _flash_cuda(q, k, v, causal=causal, window=window, scale=scale,
                       kv_block=kv_chunk)
