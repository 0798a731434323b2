"""Wrappers for the pairwise distance reductions and the fused greedy round
(port of repro/kernels/pairwise/ops.py).

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (``csrc/``) or raises; a CPU tensor takes the plain version in
``ref``. ``impl="ref"`` forces the plain version on any device, so the
kernels can be timed against it on the card; the serving path never
passes it.

Besides dispatch, this layer does the reference's op accounting: inside
``track_ops()`` every wrapper records the full (N, d) pool reads and (N,)
vector streams it issues. ``LAUNCHES`` counts kernel launches per kernel,
one per wrapper call that reaches the card.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels.pairwise import autotune, ref
from repro_torch.kernels.pairwise.ref import BIG

# ------------------------------------------------------- op accounting ----
_STATS = {"embedding_reads": 0, "vector_streams": 0, "hbm_bytes": 0,
          "pool_rows": 0}
_TRACKING = [False]

# kernel launches on the card, by kernel; plain-version calls add nothing
LAUNCHES = {"greedy_round": 0, "pairwise_min_argmin": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_op_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


@contextlib.contextmanager
def track_ops():
    """Count embedding-pool reads / vector streams issued while active."""
    reset_op_stats()
    _TRACKING[0] = True
    try:
        yield _STATS
    finally:
        _TRACKING[0] = False


def _record(x, emb_reads: int = 0, vec_streams: int = 0) -> None:
    if not _TRACKING[0]:
        return
    n, d = x.shape
    _STATS["embedding_reads"] += emb_reads
    _STATS["vector_streams"] += vec_streams
    _STATS["hbm_bytes"] += 4 * (emb_reads * n * d + vec_streams * n)
    _STATS["pool_rows"] += emb_reads * n


def record_pool_rows(n: int) -> None:
    """Explicit pool-rows-touched tally for passes that do not flow through
    an (N, d) wrapper here (uncertainty scoring over probs rows)."""
    if _TRACKING[0]:
        _STATS["pool_rows"] += int(n)


# ------------------------------------------------------------ dispatch ----
def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, expected {device}")
    return t.to(torch.float32).contiguous()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


_BOUND = {}


def _lib(name: str):
    """The kernel's ctypes entry point, with its argument types set."""
    fn = _BOUND.get(name)
    if fn is None:
        from repro_torch.kernels import build
        lib = build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "greedy_round":
            fn = lib.greedy_round_f32
            fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
            lib.greedy_round_rows_per_block.argtypes = []
            lib.greedy_round_rows_per_block.restype = i
            fn.rows_per_block = int(lib.greedy_round_rows_per_block())
        else:
            fn = lib.pairwise_min_argmin_f32
            fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
        fn.restype = i
        _BOUND[name] = fn
    return fn


# ------------------------------------------------- pairwise reductions ----
def _pairwise_min_and_argmin_cuda(x, c):
    dev = x.device
    x, c = _f32(x, dev), _f32(c, dev)
    n, d = x.shape
    m, dc = c.shape
    if dc != d:
        raise ValueError(f"x has {d} features, centers have {dc}")
    fn = _lib("pairwise_min_argmin")
    x2 = torch.empty((n,), dtype=torch.float32, device=dev)
    c2 = torch.empty((m,), dtype=torch.float32, device=dev)
    out_min = torch.empty((n,), dtype=torch.float32, device=dev)
    out_arg = torch.empty((n,), dtype=torch.int32, device=dev)
    _check(fn(_ptr(x), _ptr(c), _ptr(x2), _ptr(c2), _ptr(out_min),
              _ptr(out_arg), n, m, d, _stream(dev)), "pairwise_min_argmin")
    LAUNCHES["pairwise_min_argmin"] += 1
    return out_min, out_arg


def pairwise_min_and_argmin(x, c, impl: str = "auto"):
    """Both (min_d (N,) f32, argmin (N,) i32) from ONE pass: ties go to the
    lowest center index."""
    _record(x, emb_reads=1, vec_streams=2)
    if _use_kernel(x, impl):
        return _pairwise_min_and_argmin_cuda(x, c)
    return ref.pairwise_min_and_argmin_ref(x, c)


def pairwise_argmin(x, c, impl: str = "auto"):
    return pairwise_min_and_argmin(x, c, impl)[1]


def pairwise_sq_dists(x, c):
    """Full (N, M) matrix — only for small M (DBAL centroid matching).
    A plain matrix product, as the reference leaves it to XLA."""
    _record(x, emb_reads=1)
    return ref.pairwise_sq_dists_ref(x, c)


def sq_dist_to_center(x, center):
    _record(x, emb_reads=1, vec_streams=1)
    diff = x.float() - center.float()[None, :]
    return torch.sum(diff * diff, dim=-1)


# ---------------------------------------------- fused greedy selection ----
def masked_weighted_score(mind, weights=None):
    """Host-side mirror of the fused round's argmax score rule: selected
    rows (mind < 0) pin to -BIG BEFORE the weight multiply."""
    score = mind if weights is None else mind * weights
    return torch.where(mind < 0.0, -BIG, score)


def _greedy_round_cuda(x, mind, centers, sel_idx, weights):
    dev = x.device
    x, mind, centers = _f32(x, dev), _f32(mind, dev), _f32(centers, dev)
    w = None if weights is None else _f32(weights, dev)
    sel = sel_idx.to(device=dev, dtype=torch.int32).contiguous()
    n, d = x.shape
    r = centers.shape[0]
    if centers.shape[1] != d or mind.shape != (n,) or \
            (w is not None and w.shape != (n,)):
        raise ValueError("greedy_round: shapes do not match the (N, d) pool")
    fn = _lib("greedy_round")
    nb = -(-n // fn.rows_per_block)
    nmind = torch.empty((n,), dtype=torch.float32, device=dev)
    bmax = torch.empty((nb,), dtype=torch.float32, device=dev)
    barg = torch.empty((nb,), dtype=torch.int32, device=dev)
    _check(fn(_ptr(x), _ptr(mind), _ptr(centers), _ptr(sel), _ptr(w),
              _ptr(nmind), _ptr(bmax), _ptr(barg), n, d, r, _stream(dev)),
           "greedy_round")
    LAUNCHES["greedy_round"] += 1
    # the first block holding the max owns the lowest tied index
    win = torch.argmax(bmax)
    return nmind, barg[win], bmax[win]


def greedy_round(x, mind, centers, sel_idx, weights=None,
                 impl: str = "auto"):
    """One fused greedy round: one (N, d) pool read folds the (R, d) queued
    ``centers`` into ``mind``, masks ``sel_idx`` (-1 = no mask), and
    returns the next (weighted) farthest point.
    -> (new_mind (N,) f32, next_idx () i32, next_score () f32).

    ``weights`` (optional (N,), non-negative) scale the argmax score only,
    never the returned min-dist. Selected rows (new or carried-in -1)
    score -BIG, and exact score ties go to the lowest pool index."""
    if sel_idx.shape[0] != centers.shape[0]:
        raise ValueError(
            f"sel_idx must mask exactly the queued centers: got "
            f"{sel_idx.shape[0]} indices for {centers.shape[0]} centers")
    _record(x, emb_reads=1, vec_streams=2)
    if _use_kernel(x, impl):
        return _greedy_round_cuda(x, mind, centers, sel_idx, weights)
    return ref.greedy_round_ref(x, mind, centers, sel_idx, weights)


def warm_start_min_dist(x, centers, impl: str = "auto",
                        r_block: int | None = None):
    """Min sq-dist from every pool row to ANY of (M, d) ``centers`` — the
    Core-Set warm start. Folds ``r_block`` centers per fused pass, chunked
    exactly as the reference chunks on the CPU (``autotune.model_blocks``),
    since a one-center chunk takes the difference form."""
    if r_block is None:
        r_block = autotune.model_blocks(x.shape[0], x.shape[1]).r_block
    N = x.shape[0]
    M = centers.shape[0]
    mind = torch.full((N,), BIG, dtype=torch.float32, device=x.device)
    for s in range(0, M, r_block):
        chunk = centers[s:s + r_block]
        mind = greedy_round(
            x, mind, chunk,
            torch.full((chunk.shape[0],), -1, dtype=torch.int32,
                       device=x.device), impl=impl)[0]
    return mind
