"""Wrapper for the flash-attention forward kernels (port of
repro/kernels/flash_attention/ops.py).

Dispatch follows the tensor: a CUDA tensor launches a hand-written
kernel or raises; a CPU tensor takes the plain chunked path with
``q_chunk`` and ``kv_chunk``, as the reference does off the TPU.
``impl="ref"`` takes the naive plain version on any device, so the
kernels can be timed against it on the card; the serving path never
passes it.

On the card, bf16 goes to ``csrc/flash_attention_bf16.cu`` as it is:
the tensor-core kernel reads and writes bf16, walks fixed KV tiles of 64
keys and ignores ``kv_chunk`` (the reference's own kernel branch drops
it too), and takes head dims 16, 32, 64, 128 and 256; any other head dim
up to 256 is zero-padded to the next of these and the output sliced back
(zero features add nothing to q.k and give zero output columns; the
scale stays the caller's). Every other dtype goes to
``csrc/flash_attention.cu``, which computes in fp32: its KV tile is
``kv_chunk`` (clamped to Skv), the grid the chunked path and the
reference's interpret lane use, so a row's online-softmax trajectory is
the chunked path's; non-fp32 inputs are cast up for it and its output is
cast back. Every path returns ``q.dtype``.
``LAUNCHES`` counts kernel launches of both, one per call that reaches
the card.
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


_FN = {}


def _lib(name: str = "flash_attention"):
    fn = _FN.get(name)
    if fn is None:
        from repro_torch.kernels import build
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "flash_attention":
            fn = build.load(name).flash_attention_fwd_f32
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                           ctypes.c_float, p]
        else:
            fn = build.load(name).flash_attention_fwd_bf16
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                           ctypes.c_float, p]
        fn.restype = i
        _FN[name] = fn
    return fn


# head dims the bf16 kernel is instantiated for
BF16_HEAD_DIMS = (16, 32, 64, 128, 256)


def padded_head_dim(d: int) -> int:
    """The bf16 kernel's head dim for a head dim of ``d``: the smallest
    instance that holds it. Raises ValueError past 256."""
    for p in BF16_HEAD_DIMS:
        if d <= p:
            return p
    raise ValueError(f"the bf16 flash_attention kernel does not take "
                     f"head_dim {d} (at most {BF16_HEAD_DIMS[-1]})")


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` (..., D) zero-padded to (..., d), contiguous."""
    pad = d - t.shape[-1]
    return (torch.nn.functional.pad(t, (0, pad)) if pad else t).contiguous()


def _check_shapes(q, k, v):
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must lie on one device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,D) and k, v (B,Skv,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, D, H = q.shape[0], q.shape[3], q.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")


def _flash_cuda_bf16(q, k, v, *, causal: bool, window: Optional[int],
                     scale: float):
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    dp = padded_head_dim(D)
    q, k, v = (pad_head_dim(t, dp) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :D].contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash_attention kernel copies 16-byte "
                         "chunks: q, k and v must be 16-byte aligned")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib("flash_attention_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, KH, dp, int(causal), 0 if window is None else int(window),
        float(scale), stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the bf16 flash_attention kernel does not take "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)} (at most "
                         f"65,535 batch rows and 65,535 query tiles)")
    if err != 0:
        raise RuntimeError(f"flash_attention_bf16 kernel launch failed: "
                           f"CUDA error {err}")
    launches.bump(LAUNCHES, "flash_attention")
    return out if dp == D else out[..., :D].contiguous()


def _flash_cuda(q, k, v, *, causal: bool, window: Optional[int],
                scale: float, kv_block: int):
    dev = q.device
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
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


def attended_pairs(sq: int, skv: int, causal: bool,
                   window: Optional[int]) -> int:
    """(query, key) pairs the masks allow, query row i at key position
    skv - sq + i."""
    total = 0
    for i in range(sq):
        p = skv - sq + i
        lo = 0 if window is None else max(0, p - window + 1)
        hi = p + 1 if causal else skv
        total += max(0, min(hi, skv) - lo)
    return total


def _stand_in(q, k, v, *, causal: bool, window: Optional[int]):
    """A dry run's launch (``launches.stand_in``): the output's shape, and
    the kernel's FLOPs (4 * D a (query head, key) pair the masks allow)
    and bytes (q, k, v read once, o written once: its floor)."""
    B, Sq, H, D = q.shape
    pairs = (attended_pairs(Sq, k.shape[1], causal, window)
             if causal or window is not None else Sq * k.shape[1])
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    launches.stand_in("flash_attention", 4.0 * B * H * D * pairs, nbytes)
    return torch.empty_like(q)


def flash_attention_auto(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None, q_chunk: int = 512,
                         kv_chunk: int = 1024, impl: str = "auto"):
    """q: (B,Sq,H,D); k,v: (B,Skv,KH,D) -> (B,Sq,H,D), causal and optional
    sliding-window masks, GQA. A row's result depends on ``kv_chunk`` and
    never on ``q_chunk`` or Sq."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    launches.refuse_dtensor(q, k, v)
    if impl == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if launches.standing_in(q):
        return _stand_in(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        from repro_torch.models.layers.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    if q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return _flash_cuda_bf16(q, k, v, causal=causal, window=window,
                                scale=scale)
    return _flash_cuda(q, k, v, causal=causal, window=window, scale=scale,
                       kv_block=kv_chunk)
