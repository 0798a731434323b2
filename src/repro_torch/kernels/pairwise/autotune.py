"""Block picker for the fused greedy rounds on the H100 (port of
repro/kernels/pairwise/autotune.py).

Two block sizes steer the selection kernels:

``n_block``
    Rows per CTA of the fused round (``csrc/greedy_round.cu``) and the
    gate block of the block-masked round (``csrc/gated_greedy_round.cu``,
    which cuts each gate block into row tiles of ``ops.gated_plan``'s
    size, one CTA a tile). It changes no float of either kernel's output
    (a row's sums run in an order fixed by d whatever the block), only
    how many CTAs stream the pool and how many partials the launch's last
    CTA reduces.
``r_block``
    Centers folded per fused pass in ``ops.warm_start_min_dist``. A
    one-center chunk takes the difference form and every other chunk the
    matmul form, so the chunking IS visible in the floats. ``r_block``
    therefore stays the reference's model pick (``model_blocks``) on every
    device and is never re-derived at a measured ``n_block``: if it varied
    with measurement, CPU parity of the Core-Set warm start, persisted
    state == from scratch, and sharded == unsharded would all break.

The model is the reference's: HBM bytes per round under its TPU tile
budget. Off the card (``measure=False``) it alone decides, so the CPU pick
equals the reference's ``autotune_blocks(measure=False)``. On the card
(``measure=None`` with a CUDA ``device``, or ``measure=True``) every
``n_block`` that fits Hopper's budget is timed with CUDA events at full
occupancy and the fastest wins. The two kernels keep no whole row or
center on chip: the difference form streams rows through registers and
reads its one center through the L1 cache, the matmul form stages
16-feature slices of a 64-row tile and its centers (at most 32 KB of
static shared memory a CTA, the gated round's running min included),
whatever ``n_block`` and d are; so every candidate launches at every d.

Winners are cached per (N, d, dtype, variant) — ``"round"`` (the plain
fused round) and ``"gated"`` (the block-masked round) never share an entry
— and persist as one small JSON per key in ``REPRO_TORCH_AUTOTUNE_CACHE_DIR``
(default ``~/.cache/repro_torch/pairwise-autotune``; the empty string
disables it), written then renamed. Each entry carries the hash of the
kernel source it was measured on (``build.source_hash``). A corrupt,
stale-format or no longer feasible entry, or one measured on another
version of the kernel, is ignored and re-tuned.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Optional, Tuple

import torch

N_BLOCK_CANDIDATES = (64, 128, 256, 512, 1024)
R_BLOCK_CANDIDATES = (8, 32, 64, 128, 256, 512)

# the reference's TPU tile budget (half of ~16 MB VMEM per core): the model
VMEM_BUDGET_BYTES = 8 * 1024 * 1024

VARIANTS = ("round", "gated")
# the kernel source each variant's winners were measured on
_SOURCES = {"round": "greedy_round", "gated": "gated_greedy_round"}


@dataclasses.dataclass(frozen=True)
class BlockChoice:
    n_block: int
    r_block: int
    hbm_bytes: float = 0.0     # modeled bytes per fused round at (n, R=1)
    wall_s: float = 0.0        # measured s per round (0.0 when model-only)
    source: str = "model"      # "model" | "measured"
    # measured s per round of every timed n_block, as (n_block, s) pairs
    timed: Tuple[Tuple[int, float], ...] = ()


_CACHE: Dict[Tuple[int, int, str, str], BlockChoice] = {}
_LOCK = threading.RLock()

# bump when the candidate sets, the model or the entry schema change
_DISK_FORMAT = 2


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def round_hbm_bytes(n: int, d: int, dtype_bytes: float, n_block: int,
                    r_block: int) -> float:
    """Modeled bytes of ONE fused greedy round: pool read + min-dist
    read/write + weight read + per-block center re-fetch + partials."""
    nb = min(n_block, n)
    nn = -(-n // nb)
    np_ = nn * nb
    rp = _pad_to(max(r_block, 1), 8)
    pool = np_ * d * dtype_bytes
    vectors = 3 * 4 * np_
    centers = nn * rp * (d * 4 + 4)
    partials = nn * 2 * 4
    return pool + vectors + centers + partials


def tile_vmem_bytes(d: int, dtype_bytes: float, n_block: int,
                    r_block: int) -> float:
    rp = _pad_to(max(r_block, 1), 8)
    row = n_block * d * (dtype_bytes + 4)
    cen = rp * d * (dtype_bytes + 4)
    dist = n_block * rp * 4
    vecs = 4 * n_block * 4
    return row + cen + dist + vecs


def _feasible(d: int, dtype_bytes: float, n_block: int, r_block: int) -> bool:
    return tile_vmem_bytes(d, dtype_bytes, n_block, r_block) \
        <= VMEM_BUDGET_BYTES


def hopper_feasible(d: int, n_block: int) -> bool:
    """Whether the selection kernels launch at this (d, n_block) on the
    H100: a CTA needs a row, and nothing of d stays on chip (the module
    docstring), so every width launches."""
    return d >= 1 and n_block >= 1


def model_blocks(n: int, d: int, dtype_bytes: float = 4.0) -> BlockChoice:
    """The reference's model-only ``(n_block, r_block)`` for an (n, d)
    pool: the largest feasible row block by modeled bytes at R = 1, then
    the ``r_block`` with the fewest modeled bytes per folded center."""
    n_cands = [nb for nb in N_BLOCK_CANDIDATES
               if _feasible(d, dtype_bytes, nb, 8)] or [N_BLOCK_CANDIDATES[0]]
    best_nb = min(n_cands,
                  key=lambda nb: (round_hbm_bytes(n, d, dtype_bytes, nb, 1),
                                  -nb))
    r_cands = [rb for rb in R_BLOCK_CANDIDATES
               if _feasible(d, dtype_bytes, best_nb, rb)] or \
        [R_BLOCK_CANDIDATES[0]]
    best_rb = min(r_cands,
                  key=lambda rb: (round_hbm_bytes(n, d, dtype_bytes, best_nb,
                                                  rb) / rb, -rb))
    return BlockChoice(best_nb, best_rb,
                       round_hbm_bytes(n, d, dtype_bytes, best_nb, 1))


# ------------------------------------------------------------ disk cache --
def cache_dir() -> Optional[str]:
    """Result directory for persisted winners; None when disabled."""
    d = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE_DIR")
    if d == "":
        return None
    return d or os.path.join(os.path.expanduser("~"), ".cache",
                             "repro_torch", "pairwise-autotune")


def _disk_path(key) -> Optional[str]:
    d = cache_dir()
    if d is None:
        return None
    return os.path.join(d, f"n{key[0]}_d{key[1]}_{key[2]}_{key[3]}.json")


def body_version(variant: str) -> str:
    """The hash of the kernel source a ``variant``'s winners are measured
    on: an entry from another version of the round body is re-tuned."""
    from repro_torch.kernels import build
    return build.source_hash(_SOURCES[variant])


def _dtype_bytes(name: str) -> float:
    return float(torch.empty((), dtype=getattr(torch, name)).element_size())


def _disk_load(key) -> Optional[BlockChoice]:
    path = _disk_path(key)
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            raw = json.load(f)
        if raw.get("format") != _DISK_FORMAT or \
                raw.get("body") != body_version(key[3]):
            return None
        choice = BlockChoice(
            int(raw["n_block"]), int(raw["r_block"]),
            float(raw["hbm_bytes"]), float(raw["wall_s"]),
            str(raw["source"]),
            tuple((int(nb), float(s)) for nb, s in raw.get("timed", ())))
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None     # corrupt entry: fall through and re-tune
    # never serve blocks the CURRENT candidates / model would reject
    n, d = key[0], key[1]
    model = model_blocks(n, d, _dtype_bytes(key[2]))
    if choice.n_block not in N_BLOCK_CANDIDATES \
            or choice.r_block != model.r_block \
            or choice.source not in ("model", "measured") \
            or (choice.source == "model" and choice.n_block != model.n_block) \
            or not hopper_feasible(d, choice.n_block):
        return None
    return choice


def _disk_store(key, choice: BlockChoice) -> None:
    path = _disk_path(key)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # write-then-rename: a killed run never leaves a torn entry
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"format": _DISK_FORMAT,
                       "body": body_version(key[3]),
                       **dataclasses.asdict(choice)}, f)
        os.replace(tmp, path)
    except OSError:
        pass            # persistence is best-effort; the run still has _CACHE


# ------------------------------------------------------------ measuring --
def _time_rounds(run, reps: int) -> float:
    """s per call of ``run`` (a CUDA launch), from CUDA events around
    ``reps`` calls after one warm-up call."""
    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / reps


def _measure(n: int, d: int, dtype, device, variant: str, n_blocks,
             reps: int = 10) -> Dict[int, float]:
    """Wall clock of one round at each ``n_block`` on the card, R = 1, at
    full occupancy (every gate block live for ``"gated"``). Launches go
    through the kernel wrappers, so they count in ``ops.LAUNCHES``; they
    record no op accounting."""
    from repro_torch.kernels.pairwise import ops
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=device).to(dtype)
    mind = torch.full((n,), 3.4e38, dtype=torch.float32, device=device)
    c = x[:1]
    out = {}
    for nb in n_blocks:
        if variant == "gated":
            nn = -(-n // min(nb, n))
            live = torch.ones((nn,), dtype=torch.int32, device=device)
            pend = torch.zeros((nn,), dtype=torch.int32, device=device)

            def run(nb=nb, live=live, pend=pend):
                ops._gated_greedy_round_cuda(x, mind, c, live, pend, None, nb)
        else:
            sel = torch.full((1,), -1, dtype=torch.int32, device=device)

            def run(nb=nb, sel=sel):
                ops._greedy_round_cuda(x, mind, c, sel, None, nb)
        out[nb] = _time_rounds(run, reps)
    return out


def autotune_blocks(n: int, d: int, dtype=torch.float32,
                    measure: Optional[bool] = None,
                    variant: str = "round", device=None) -> BlockChoice:
    """Best (n_block, r_block) for an (N, d) pool of ``dtype``, cached per
    round ``variant`` ("round" = plain fused, "gated" = block-masked).
    ``measure=None`` measures exactly when ``device`` is a CUDA device
    (the pool lives on the card)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    dt_name = str(dtype).replace("torch.", "")
    key = (int(n), int(d), dt_name, variant)
    device = None if device is None else torch.device(device)
    if measure is None:
        measure = device is not None and device.type == "cuda"
    with _LOCK:
        hit = _CACHE.get(key)
        if hit is not None and (hit.source == "measured" or not measure):
            return hit
        disk = _disk_load(key)
        if disk is not None and (disk.source == "measured" or not measure):
            _CACHE[key] = disk
            return disk
        dtype_bytes = _dtype_bytes(dt_name)
        model = model_blocks(n, d, dtype_bytes)
        choice = model
        if measure:
            if device is None or device.type != "cuda":
                device = torch.device("cuda")
            cands = [nb for nb in N_BLOCK_CANDIDATES
                     if hopper_feasible(d, nb)]
            timed = _measure(n, d, dtype, device, variant, cands)
            best = min(timed, key=lambda nb: (timed[nb], -nb))
            # r_block stays the model's: it is visible in the floats
            choice = BlockChoice(
                best, model.r_block,
                round_hbm_bytes(n, d, dtype_bytes, best, 1), timed[best],
                "measured", tuple(sorted(timed.items())))
        _CACHE[key] = choice
        _disk_store(key, choice)
        return choice


def report() -> Dict[Tuple[int, int, str, str], BlockChoice]:
    """Cached winners keyed by (N, d, dtype name, variant)."""
    with _LOCK:
        return dict(_CACHE)


def clear_cache() -> None:
    """Clear the in-memory cache only; persisted winners stay on disk (the
    next autotune_blocks reloads them, exactly like a fresh process)."""
    with _LOCK:
        _CACHE.clear()
