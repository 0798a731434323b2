"""Wrappers for the pairwise distance reductions and the fused greedy round
(port of repro/kernels/pairwise/ops.py).

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (``csrc/``) or raises; a CPU tensor takes the plain version in
``ref``. ``impl="ref"`` forces the plain version on any device, so the
kernels can be timed against it on the card; the serving path never
passes it.

Besides dispatch, this layer does the reference's op accounting: inside
``track_ops()`` every wrapper records the full (N, d) pool reads and (N,)
vector streams it issues (a gated round only its live rows).
``LAUNCHES`` counts kernel launches per kernel, one per wrapper call that
reaches the card. Replica lanes call these wrappers from several threads,
so both tallies update under locks.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.kernels import launches
from repro_torch.kernels.pairwise import autotune, ref
from repro_torch.kernels.pairwise.ref import BIG

# ------------------------------------------------------- op accounting ----
# ``pool_rows`` counts POOL ROWS TOUCHED: rows whose feature vector (or
# probs row) a selection pass actually read or scored. The centroid
# prefilter's savings are stated in these units.
_STATS = {"embedding_reads": 0, "vector_streams": 0, "hbm_bytes": 0,
          "pool_rows": 0}
_TRACKING = [False]
_STATS_LOCK = threading.Lock()

# kernel launches on the card, by kernel; plain-version calls add nothing
LAUNCHES = {"greedy_round": 0, "pairwise_min_argmin": 0,
            "gated_greedy_round": 0}


def reset_launches() -> None:
    launches.reset(LAUNCHES)


def reset_op_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def op_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


@contextlib.contextmanager
def track_ops():
    """Count embedding-pool reads / vector streams issued while active."""
    reset_op_stats()
    _TRACKING[0] = True
    try:
        yield _STATS
    finally:
        _TRACKING[0] = False


def _add(embedding_reads=0, vector_streams=0, hbm_bytes=0,
         pool_rows=0) -> None:
    with _STATS_LOCK:
        _STATS["embedding_reads"] += embedding_reads
        _STATS["vector_streams"] += vector_streams
        _STATS["hbm_bytes"] += hbm_bytes
        _STATS["pool_rows"] += pool_rows


def _record(x, emb_reads: int = 0, vec_streams: int = 0) -> None:
    if not _TRACKING[0]:
        return
    n, d = x.shape
    _add(emb_reads, vec_streams, 4 * (emb_reads * n * d + vec_streams * n),
         emb_reads * n)


def record_pool_rows(n: int) -> None:
    """Explicit pool-rows-touched tally for passes that do not flow through
    an (N, d) wrapper here (uncertainty scoring over probs rows, gated
    cluster scans)."""
    if _TRACKING[0]:
        _add(pool_rows=int(n))


# ------------------------------------------------------------ dispatch ----
def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    launches.refuse_dtensor(x)
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, expected {device}")
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def _i32(t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, expected {device}")
    if t.dtype is torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# Each launch below runs on the tensors' device (``torch.cuda.device``
# where it is not the current one): a ctypes launch goes to the current
# device, which a worker lane pinned to another card (distributed.worker)
# may have switched.
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
            fn.argtypes = [p] * 10 + [i] * 4 + [p]
        elif name == "gated_greedy_round":
            fn = lib.gated_greedy_round_f32
            fn.argtypes = [p] * 11 + [i] * 6 + [p]
        else:
            fn = lib.pairwise_min_argmin_f32
            fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        _BOUND[name] = fn
    return fn


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_ptr(index: int) -> int:
    """The current stream of CUDA device ``index``, as a pointer value."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


# The greedy rounds' in-launch argmax elects the last CTA by an integer
# ticket: one counter per (device, stream), zeroed once here and left at 0
# by every launch, so concurrent callers on different streams (replica
# lanes) never share one and a launch needs no fill before it.
_TICKETS = {}
_TICKETS_LOCK = threading.Lock()


def _ticket(index: int, stream: int) -> int:
    t = _TICKETS.get((index, stream))
    if t is None:
        with _TICKETS_LOCK:
            t = _TICKETS.get((index, stream))
            if t is None:
                t = _TICKETS[index, stream] = torch.zeros(
                    (1,), dtype=torch.int32, device=torch.device("cuda", index))
    return t.data_ptr()


def _launch(fn, index: int, ptrs, ints) -> int:
    """Calls a greedy round's C launcher on device ``index``: its pointers,
    the current stream's ticket, its ints and the stream itself last."""
    stream = _stream_ptr(index)
    args = (*ptrs, _ticket(index, stream), *ints, stream)
    if index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


# ------------------------------------------------- pairwise reductions ----
# The min/argmin kernel's CTA tiles (rows, centers), largest first: the
# template instances of ``csrc/pairwise_min_argmin.cu``.
ARGMIN_TILES = ((128, 64), (64, 64), (32, 64), (32, 32))
H100_SMS = 132


def argmin_plan(n: int, m: int, sms: int = H100_SMS):
    """The min/argmin kernel's (rows, centers) CTA tile for an (n, m)
    call: the largest tile whose grid holds at least two CTAs per SM, or
    the smallest tile where none does. The plan changes no result, only
    how the (n, m) distances are cut among CTAs."""
    for bm, bn in ARGMIN_TILES:
        if -(-n // bm) * -(-m // bn) >= 2 * sms:
            return bm, bn
    return ARGMIN_TILES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pairwise_min_and_argmin_cuda(x, c, plan=None):
    dev = x.device
    x, c = _f32(x, dev), _f32(c, dev)
    n, d = x.shape
    m, dc = c.shape
    if dc != d:
        raise ValueError(f"x has {d} features, centers have {dc}")
    if plan is None:
        plan = argmin_plan(n, m, _sm_count(dev.index if dev.index is not None
                                           else torch.cuda.current_device()))
    bm, bn = (int(v) for v in plan)
    if (bm, bn) not in ARGMIN_TILES:
        raise ValueError(f"no min/argmin tile {plan}; one of {ARGMIN_TILES}")
    fn = _lib("pairwise_min_argmin")
    x2 = torch.empty((n,), dtype=torch.float32, device=dev)
    c2 = torch.empty((m,), dtype=torch.float32, device=dev)
    tiles = -(-m // bn)
    part_min = torch.empty((tiles, n), dtype=torch.float32, device=dev)
    part_arg = torch.empty((tiles, n), dtype=torch.int32, device=dev)
    out_min = torch.empty((n,), dtype=torch.float32, device=dev)
    out_arg = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _check(fn(_ptr(x), _ptr(c), _ptr(x2), _ptr(c2), _ptr(part_min),
                  _ptr(part_arg), _ptr(out_min), _ptr(out_arg), n, m, d, bm,
                  bn, _stream(dev)), "pairwise_min_argmin")
    launches.bump(LAUNCHES, "pairwise_min_argmin")
    return out_min, out_arg


def pairwise_min_and_argmin(x, c, impl: str = "auto", plan=None):
    """Both (min_d (N,) f32, argmin (N,) i32) from ONE pass: ties go to the
    lowest center index. ``plan`` forces the kernel's (rows, centers) CTA
    tile (one of ``ARGMIN_TILES``; default ``argmin_plan``); it changes no
    result."""
    _record(x, emb_reads=1, vec_streams=2)
    if _use_kernel(x, impl):
        return _pairwise_min_and_argmin_cuda(x, c, plan)
    return ref.pairwise_min_and_argmin_ref(x, c)


def pairwise_min_dist(x, c, impl: str = "auto"):
    return pairwise_min_and_argmin(x, c, impl)[0]


def pairwise_argmin(x, c, impl: str = "auto"):
    return pairwise_min_and_argmin(x, c, impl)[1]


def pairwise_sq_dists(x, c):
    """Full (N, M) matrix — only for small M (DBAL centroid matching).
    A plain matrix product, as the reference leaves it to XLA."""
    _record(x, emb_reads=1)
    return ref.matmul_sq_dists_ref(x, c)


def sq_dist_to_center(x, center):
    _record(x, emb_reads=1, vec_streams=1)
    return ref.diff_sq_dists_ref(x, center)


# ---------------------------------------------- fused greedy selection ----
def masked_weighted_score(mind, weights=None):
    """Host-side mirror of the fused round's argmax score rule: selected
    rows (mind < 0) pin to -BIG BEFORE the weight multiply."""
    score = mind if weights is None else mind * weights
    return torch.where(mind < 0.0, -BIG, score)


# ----------------------------------------------------------- the plan ----
# Rows per CTA of the fused round at d <= 512 when the caller names none:
# the block picker's winner at 50,000 x 512 on the H100 (chip_smoke.py's
# picker phase). Wider rows and smaller pools take fewer (``round_plan``),
# so the text pool (2,048 x 4,096) and the prefilter's folds (slices of
# 8-256 rows) still spread over the SMs. Serving never measures; a caller
# that wants a per-shape pick asks ``autotuned_blocks``.
ROWS_PER_CTA = 64
# the kernel's threads a CTA and chunks of a row in flight a lane
# (kThreads and kInFlight in csrc/round_block.cuh)
CTA_THREADS = 256
IN_FLIGHT = 4


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """How the fused round reads an (n, d) pool with R centers on the card.

    ``form`` and, in the difference form, ``chunk`` (floats a chunk),
    ``lanes`` (lanes that own a row) fix a row's floats: they depend on d
    and R alone (csrc/round_block.cuh states the sum orders).
    ``chunks_in_flight``/``rows_in_flight`` (loads a lane keeps in flight),
    ``rows_per_cta`` and ``ctas`` only pace the kernel."""
    form: str
    chunk: int
    lanes: int
    chunks_in_flight: int
    rows_in_flight: int
    rows_per_cta: int
    ctas: int


def round_plan(n: int, d: int, r: int = 1,
               n_block: int | None = None) -> RoundPlan:
    """The launch plan of ``greedy_round`` (mirrors the kernel's
    ``greedy_round_layout``). ``n_block`` (rows per CTA) defaults to
    ROWS_PER_CTA in the matmul form (its row tile is 64 rows); in the
    difference form to ROWS_PER_CTA * 512 / d rows, and to no more than
    two CTAs an SM of the H100 need for the pool, but never fewer than one
    row a warp."""
    chunk = 4 if d % 4 == 0 and d >= 128 else 1
    q = d // chunk
    lanes = 1
    while lanes < 32 and 2 * lanes <= q:
        lanes *= 2
    t = -(-q // lanes)
    u = 2 if t <= 2 else 4 if t <= 4 else 8
    if n_block is None:
        warps = CTA_THREADS // 32
        n_block = ROWS_PER_CTA if r > 1 else max(warps, min(
            ROWS_PER_CTA * 512 // max(d, 512), -(-int(n) // (2 * H100_SMS))))
    rows = min(int(n_block), max(int(n), 1))
    return RoundPlan("difference" if r == 1 else "matmul", chunk, lanes, u,
                     max(IN_FLIGHT // u, 1), rows, -(-int(n) // rows))


@functools.lru_cache(maxsize=1024)
def _default_rows(n: int, d: int, r: int) -> int:
    return round_plan(n, d, r).rows_per_cta


def _out(buf: torch.Tensor, n: int):
    """(new_mind, next_idx, next_score) views of a round's output buffer
    [nmind (n) | score | index bits | partials]."""
    return buf[:n], buf.view(torch.int32)[n + 1], buf[n]


def _greedy_round_cuda(x, mind, centers, sel_idx, weights,
                       n_block: int | None):
    dev = x.device
    x, mind = _f32(x, dev), _f32(mind, dev)
    n, d = x.shape
    if centers.is_floating_point():
        centers, cidx = _f32(centers, dev), None
        if centers.dim() != 2 or centers.shape[1] != d:
            raise ValueError("greedy_round: centers do not match the "
                             "(N, d) pool")
    else:
        centers, cidx = None, _i32(centers, dev)
    sel = _i32(sel_idx if sel_idx.device == dev else sel_idx.to(dev), dev)
    w = None if weights is None else _f32(weights, dev)
    r = sel.shape[0]
    if mind.shape != (n,) or (w is not None and w.shape != (n,)):
        raise ValueError("greedy_round: shapes do not match the (N, d) pool")
    rows = _default_rows(n, d, r) if n_block is None else min(int(n_block), n)
    nb = -(-n // rows)
    buf = torch.empty((n + 2 + 2 * nb,), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    _check(_launch(_lib("greedy_round"), dev.index,
                   (x.data_ptr(), mind.data_ptr(),
                    None if centers is None else centers.data_ptr(),
                    None if cidx is None else cidx.data_ptr(), sel.data_ptr(),
                    None if w is None else w.data_ptr(), base,
                    base + 4 * (n + 2), base + 4 * n), (n, d, r, rows)),
           "greedy_round")
    launches.bump(LAUNCHES, "greedy_round")
    return _out(buf, n)


def autotuned_blocks(n: int, d: int, dtype=torch.float32, device=None,
                     variant: str = "round"):
    """The block picker's cached (n_block, r_block) winner for this shape
    (measured on the card when ``device`` is a CUDA device)."""
    return autotune.autotune_blocks(n, d, dtype, device=device,
                                    variant=variant)


def greedy_round(x, mind, centers, sel_idx, weights=None,
                 impl: str = "auto", n_block: int | None = None):
    """One fused greedy round: one (N, d) pool read folds the R queued
    ``centers`` into ``mind``, masks ``sel_idx`` (-1 = no mask), and
    returns the next (weighted) farthest point.
    -> (new_mind (N,) f32, next_idx () i32, next_score () f32).

    ``centers`` is (R, d) rows, or an (R,) integer tensor of rows of ``x``
    (the kernel reads them in place: a k-center round folds the row it
    just picked without gathering it first). ``weights`` (optional (N,),
    non-negative) scale the argmax score only, never the returned
    min-dist. Selected rows (new or carried-in -1) score -BIG, and exact
    score ties go to the lowest pool index. ``n_block`` (rows per CTA on
    the card; default ``round_plan``'s) changes no result: it only sizes
    the kernel's blocks, which the plain version does not have. On the
    card the three results are views of one buffer the launch wrote: no
    reduction runs after it and nothing waits on the host."""
    if sel_idx.shape[0] != centers.shape[0]:
        raise ValueError(
            f"sel_idx must mask exactly the queued centers: got "
            f"{sel_idx.shape[0]} indices for {centers.shape[0]} centers")
    _record(x, emb_reads=1, vec_streams=2)
    if _use_kernel(x, impl):
        return _greedy_round_cuda(x, mind, centers, sel_idx, weights,
                                  n_block)
    if not centers.is_floating_point():
        centers = torch.index_select(x, 0, centers.to(x.device).long())
    return ref.greedy_round_ref(x, mind, centers, sel_idx, weights)


def greedy_round_unfused(x, mind, center, sel_idx):
    """The pre-fusion round (distance pass, minimum pass, scatter, argmax
    pass as separate torch ops), kept as the microbenchmark baseline of
    the fused round. Plain torch on the tensors' device: it stands in for
    no kernel and adds nothing to ``LAUNCHES``. ``center`` is one (d,)
    row, ``sel_idx`` the index (or indices) to mask with -1.
    -> (new_mind (N,) f32, next_idx () i32, next_score () f32); the
    argmax goes to the first maximum."""
    _record(x, emb_reads=1, vec_streams=6)
    nm = torch.minimum(mind.float(), ref.diff_sq_dists_ref(x, center))
    nm[torch.as_tensor(sel_idx, device=nm.device).long()] = -1.0
    nxt = torch.argmax(nm).to(torch.int32)
    return nm, nxt, nm[nxt]


# Rows a tile of the gated round: powers of two up to the most the
# kernel's shared running min holds (kMaxTileRows in
# csrc/gated_greedy_round.cu).
GATED_TILE_ROWS = (8, 16, 32, 64, 128, 256)


def gated_plan(n: int, d: int, n_block: int) -> int:
    """Rows a CTA tile of ``gated_greedy_round`` for an (n, d) pool in
    gate blocks of ``n_block`` rows: B1's rows per CTA at this d
    (``round_plan``'s ROWS_PER_CTA * 512 / d, at least one row a warp),
    clipped to the gate block. Not fewer for a few live rows: every tile
    of a dead block is a CTA that copies its min-dists and joins the
    launch's ticket and final merge, so smaller tiles cost more in dead
    blocks than they win in live ones (on the H100 at 50,000 x 512 and
    ~10 % live, 64-row tiles beat 32 and 16 in both forms; PERF.md). It
    changes no float and no index."""
    tile = max(CTA_THREADS // 32, ROWS_PER_CTA * 512 // max(d, 512))
    tile = max(t for t in GATED_TILE_ROWS if t <= tile)
    return min(tile, max(1, min(int(n_block), int(n))))


def _gated_out(buf: torch.Tensor, n: int, nn: int):
    """(new_mind, next_idx, next_score, blocks) views of a gated round's
    buffer [nmind (n) | score | index bits | block maxima (nn) | block
    index bits (nn) | tile pairs]; ``blocks`` is (2, nn) float32, its row
    1 the int32 bits."""
    return (buf[:n], buf.view(torch.int32)[n + 1], buf[n],
            buf[n + 2:n + 2 + 2 * nn].view(2, nn))


def _gated_greedy_round_cuda(x, mind, centers, live, pend, weights,
                             n_block: int, forms=None, tile_rows=None,
                             matmul=None):
    dev = x.device
    x, mind, centers = _f32(x, dev), _f32(mind, dev), _f32(centers, dev)
    w = None if weights is None else _f32(weights, dev)
    n, d = x.shape
    r = centers.shape[0]
    if centers.shape[1] != d or mind.shape != (n,) or \
            (w is not None and w.shape != (n,)):
        raise ValueError("gated_greedy_round: shapes do not match the "
                         "(N, d) pool")
    nb_rows = min(int(n_block), n)
    nn = -(-n // nb_rows)
    if tile_rows is None:
        tile_rows = gated_plan(n, d, nb_rows)
    tile = min(int(tile_rows), nb_rows)
    if tile not in GATED_TILE_ROWS and tile != nb_rows:
        raise ValueError(f"tile_rows {tile_rows}: one of {GATED_TILE_ROWS}")
    tpb = -(-nb_rows // tile)
    f = None
    if forms is not None:
        if matmul is None:
            matmul = (forms.device.type != "cpu"
                      or bool((forms != 0).any()))
        f = forms.to(dev, torch.int8).contiguous()
        if f.shape != (r,):
            raise ValueError(f"forms must hold one entry per center: got "
                             f"{tuple(f.shape)} for {r}")
    live, pend = _i32(live.to(dev), dev), _i32(pend.to(dev), dev)
    if live.shape != (nn,) or pend.shape != (nn,):
        raise ValueError(f"block vectors must have one entry per row block: "
                         f"got {live.shape[0]}/{pend.shape[0]} for {nn}")
    buf = torch.empty((n + 2 + 2 * nn + 2 * nn * tpb,), dtype=torch.float32,
                      device=dev)
    base = buf.data_ptr()
    _check(_launch(_lib("gated_greedy_round"), dev.index,
                   (x.data_ptr(), mind.data_ptr(), centers.data_ptr(),
                    live.data_ptr(), pend.data_ptr(),
                    None if f is None else f.data_ptr(),
                    None if w is None else w.data_ptr(), base,
                    base + 4 * (n + 2), base + 4 * n),
                   (n, d, r, int(n_block), tile,
                    1 if f is None or matmul else 0)),
           "gated_greedy_round")
    launches.bump(LAUNCHES, "gated_greedy_round")
    return _gated_out(buf, n, nn)


def _matmul_pending(forms, live, pend) -> bool:
    """Whether a live block has a form-1 center among ``[pend[b], R)``."""
    f = forms.cpu().numpy() != 0
    after = np.append(np.logical_or.accumulate(f[::-1])[::-1], False)
    p = np.clip(pend.cpu().numpy(), 0, f.shape[0])
    return bool((after[p] & (live.cpu().numpy() > 0)).any())


def _int_vector(v) -> torch.Tensor:
    return (v.to(torch.int32) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), dtype=torch.int32))


def gated_greedy_round(x, mind, centers, block_live, block_pending,
                       weights=None, impl: str = "auto", n_block: int = 256,
                       *, forms=None, tile_rows: int | None = None,
                       matmul: bool | None = None, blocks: bool = False,
                       account: bool = True):
    """The BLOCK-MASKED round variant behind the centroid prefilter.

    Folds queued ``centers`` (R, d) into ``mind`` for LIVE row blocks only:
    block ``b`` (rows ``[b*n_block, (b+1)*n_block)``) is touched iff
    ``block_live[b]``, and folds only centers ``[block_pending[b]:R)``.
    Dead blocks pass ``mind`` through untouched and emit -BIG partials, so
    the returned argmax ranges over live rows only; a live block with
    nothing pending scores its min-dists as they are. Winner masking stays
    with the caller (set the winner's ``mind`` slot to -1.0).

    ``forms`` (optional, (R,) 0/1): center ``k`` folds in the difference
    form where it is 0 (the plain round's R = 1 body) and in the matmul
    form where it is 1. Without it every center takes the matmul form, as
    the reference's kernel does. The min over centers is exact, so one
    call folding entries ``[p, R)`` equals one ``greedy_round`` call per
    entry, bit for bit, when each single-center entry has form 0 and
    each multi-center entry form 1. ``matmul=False`` (with ``forms``)
    says that no live block has a form-1 center pending, so the card runs
    its kernel without the matmul body; a launch where one is pending
    stops with a device fault, and on the CPU raises ValueError. By
    default it is read from ``forms`` where they lie on the CPU, else
    assumed. ``tile_rows`` (rows a CTA on the card; default
    ``gated_plan``'s over every row) changes no result.

    Returns ``(new_mind, next_idx, next_score)`` like ``greedy_round``;
    with ``blocks`` also the (2, nn) per-block pairs: row 0 each gate
    block's max score, row 1 the int32 bits of the lowest row index
    reaching it (``.view(torch.int32)``), in block order.
    Accounting (``account``): only live-block rows count as pool rows
    touched; a caller that keeps its own tally passes False."""
    nb = int(n_block)
    N = x.shape[0]
    nn = -(-N // min(nb, max(N, 1)))
    live = _int_vector(block_live)
    pend = _int_vector(block_pending)
    if live.shape[0] != nn:
        raise ValueError(f"block_live has {live.shape[0]} entries for "
                         f"{nn} blocks of {nb} rows over {N}")
    if forms is not None and not isinstance(forms, torch.Tensor):
        forms = torch.as_tensor(np.asarray(forms), dtype=torch.int8)
    if matmul is False and forms is None:
        raise ValueError("matmul=False needs forms: without them every "
                         "center takes the matmul form")
    if account and _TRACKING[0]:
        live_blocks = np.nonzero(live.cpu().numpy())[0]
        rows = int(sum(min(nb, N - b * nb) for b in live_blocks))
        _add(1 if rows else 0, 2, 4 * (rows * x.shape[1] + 2 * N), rows)
    if _use_kernel(x, impl):
        out = _gated_greedy_round_cuda(x, mind, centers, live, pend,
                                       weights, nb, forms, tile_rows, matmul)
    else:
        if matmul is False and _matmul_pending(forms, live, pend):
            raise ValueError("matmul=False, but a live block has a "
                             "matmul-form center pending")
        out = ref.gated_greedy_round_ref(x, mind, centers, live, pend,
                                         weights, n_block=nb, forms=forms,
                                         blocks=True)
    return out if blocks else out[:3]


def record_folds(rows, d: int, passes) -> None:
    """Op accounting of ``passes`` fused rounds over ``rows`` rows of width
    ``d`` (ints, or arrays of slices: ``passes[i]`` rounds over
    ``rows[i]`` rows), as ``greedy_round`` records each (one pool read,
    two vector streams): for a caller that folds them some other way."""
    if not _TRACKING[0]:
        return
    passes = np.asarray(passes, np.int64)
    n = int(passes.sum())
    if n > 0:
        r = int((np.asarray(rows, np.int64) * passes).sum())
        _add(n, 2 * n, 4 * (r * d + 2 * r), r)


def warm_start_min_dist(x, centers, impl: str = "auto",
                        r_block: int | None = None):
    """Min sq-dist from every pool row to ANY of (M, d) ``centers`` — the
    Core-Set warm start. Folds ``r_block`` centers per fused pass, chunked
    exactly as the reference chunks (``autotune.model_blocks``, on every
    device), since a one-center chunk takes the difference form."""
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
