"""Wrapper for the decode-attention kernel (port of
repro/kernels/decode_attention/ops.py).

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (``csrc/decode_attention.cu``) or raises; a CPU tensor takes the
plain ``decode_attention`` of the model layer, bit for bit the reference's
off-TPU path. ``impl="ref"`` forces the plain version on any device, so
the kernel can be timed against it on the card; the serving path never
passes it.

The kernel and the plain version do not compute the same bits: the plain
version rounds q to the cache dtype and the probabilities to the V dtype
before its products (as the reference's jnp function does), the kernel
keeps both in fp32 (as the reference's Pallas kernel does), and splits
the keys into chunks of ``SPLIT_KEYS`` whose partial softmaxes it merges
in chunk order (``ref.decode_attention_split_ref`` is that arithmetic in
plain PyTorch). They agree within the reference's own tolerances, 2e-4 at
fp32 and 3e-2 at bf16. On the card ``kv_block`` changes nothing: the
split unit takes its place, as the bf16 flash kernel's fixed tiles take
``kv_chunk``'s.

``cur_len`` may be an int or a 0-d int tensor on the caches' device; the
kernel reads it there, so a decode step never waits on the host.
``LAUNCHES`` counts kernel launches, one per call that reaches the card
(the split pass and the merge pass of one call count once).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import launches
from repro_torch.kernels.decode_attention import ref

LAUNCHES = {"decode_attention": 0}

KV_BLOCK = 256          # the reference kernel's default kv_block
SPLIT_KEYS = 128        # keys a CTA: kSplit in csrc/decode_attention.cu

# the C entry's code for each dtype it takes (q, caches and out alike)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the C entry's answer to a shape it does not take
_CUDA_ERROR_INVALID_VALUE = 1


def reset_launches() -> None:
    launches.reset(LAUNCHES)


_FN = []


def _lib():
    if not _FN:
        from repro_torch.kernels import build
        fn = build.load("decode_attention").decode_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
        _FN.append(fn)
    return _FN[0]


def _decode_cuda(q, k_cache, v_cache, cur_len, *, window: Optional[int],
                 scale: float):
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("q and the caches must lie on one device")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or \
            k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q (B,1,H,D) and caches (B,S,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % KH:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k_cache.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or \
            q.dtype not in _DTYPES:
        raise ValueError(f"the decode_attention kernel takes q and caches "
                         f"of one dtype, float32 or bfloat16; got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if isinstance(cur_len, torch.Tensor):
        if cur_len.device != dev or cur_len.numel() != 1:
            raise ValueError(f"cur_len must be one integer on {dev}")
        cur = cur_len.reshape(()).to(torch.int32)
    else:
        cur = torch.tensor(int(cur_len), dtype=torch.int32, device=dev)
    q, k_cache, v_cache = (t.contiguous() for t in (q, k_cache, v_cache))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_splits = -(-S // SPLIT_KEYS)
    ws = torch.empty((B, KH, n_splits, H // KH, D + 2), dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), cur.data_ptr(),
                 _DTYPES[q.dtype], B, S, H, KH, D, n_splits,
                 0 if window is None else int(window), float(scale), stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the decode_attention kernel does not take "
                         f"head_dim {D}, H {H}, B {B} (head_dim <= 256, "
                         f"H and B <= 65,535)")
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches.bump(LAUNCHES, "decode_attention")
    return out


def _stand_in(q, k_cache, v_cache, cur_len):
    """A dry run's launch (``launches.stand_in``): the output's shape, and
    the kernel's FLOPs (4 * D a query head and valid key) and bytes (q,
    the valid K/V rows, o). A traced ``cur_len`` holds no value: the
    whole cache counts."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    valid = (cur_len if isinstance(cur_len, int) else k_cache.shape[1])
    kv = 2 * B * valid * KH * D * k_cache.element_size()
    nbytes = 2 * q.numel() * q.element_size() + kv
    launches.stand_in("decode_attention", 4.0 * B * H * D * valid, nbytes)
    return torch.empty_like(q)


def decode_attention_auto(q, k_cache, v_cache, cur_len, *,
                          window: Optional[int] = None, scale=None,
                          kv_block: int = KV_BLOCK, impl: str = "auto"):
    """q: (B,1,H,D); caches (B,S,KH,D); cur_len: valid entries including
    the current token, in [1, S] -> (B,1,H,D) in q.dtype. ``kv_block`` is
    the reference kernel's KV block; neither the card's kernel (it splits
    by ``SPLIT_KEYS``) nor the plain version uses it."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    launches.refuse_dtensor(q, k_cache, v_cache)
    if impl == "ref":
        return ref.decode_attention_ref(q, k_cache, v_cache, cur_len,
                                        window=window, scale=scale)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if launches.standing_in(q):
        return _stand_in(q, k_cache, v_cache, cur_len)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, cur_len,
                                        window=window, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _decode_cuda(q, k_cache, v_cache, cur_len, window=window,
                        scale=scale)
