# Port of repro/distributed/partition.py:30-165 (the rules, pspec,
# make_rules, tree_pspecs, constrain, activation_rules and ac), over a
# torch DeviceMesh and DTensor placements in place of jax's Mesh and
# NamedSharding.
"""Logical-axis -> mesh-dim resolution (MaxText-style sharding rules).

Every parameter and activation dim carries a *logical* axis name. Rules
map a logical name to a mesh dim name (or a tuple of them). Resolution is
divisibility-aware: if a dim is not divisible by the product of the mapped
mesh dims' sizes, the rule is dropped for that dim (replicate) rather than
erroring, which lets one production mesh serve ten architectures with
head counts like 40 or 56 that a 16-way model dim does not divide.

``AxisRules.pspec`` returns a plain tuple, the counterpart of a jax
``PartitionSpec``: one entry per tensor dim, None, a mesh dim name, or a
tuple of names; trailing Nones dropped. ``placements`` turns it into one
DTensor placement per mesh dim: ``Shard(i)`` where tensor dim i names
that mesh dim, else ``Replicate()``. A tensor dim mapped to ``("pod",
"data")`` shards over both, pod outer, as the mesh orders them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.common.tree import tree_map

AxisVal = Union[None, str, Tuple[str, ...]]

# Logical axis vocabulary used across the codebase:
#   batch      activation batch                 -> (pod, data)
#   fsdp/embed parameter d_model dim            -> (pod, data)
#   tp         fused heads*head_dim / d_ff dims -> model
#   vocab      vocab dim of embed / lm_head     -> model
#   expert     MoE expert dim                   -> model
#   seq        sequence dim (SP, opt-in)        -> None by default
#   layer, norm, head_dim, window, ...          -> None
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "embed": ("pod", "data"),
    "tp": "model",
    "ff": "model",
    "qkv": "model",
    "heads": "model",
    "kv": "model",
    "vocab": "model",
    "expert": "model",
    "seq": None,
    "kv_seq": None,
    "layer": None,
    "norm": None,
    "head_dim": None,
    "lora": None,
    "stack": None,
}


@dataclasses.dataclass
class AxisRules:
    rules: Dict[str, AxisVal]
    mesh_axes: Tuple[str, ...]
    mesh_shape: Dict[str, int]

    def _axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        val = self.rules.get(logical, None)
        if val is None:
            return ()
        if isinstance(val, str):
            val = (val,)
        # keep only axes present in this mesh (e.g. "pod" absent single-pod)
        return tuple(a for a in val if a in self.mesh_axes)

    def pspec(self, logical: Sequence[Optional[str]],
              dim_sizes: Optional[Sequence[int]] = None) -> tuple:
        """Resolve a logical-axis tuple to a pspec tuple.

        Drops (a) axes already used by an earlier dim, (b) axes whose size
        does not divide the dim.
        """
        used = set()
        out = []
        for i, name in enumerate(logical):
            axes = self._axes_for(name)
            axes = tuple(a for a in axes if a not in used)
            if dim_sizes is not None and axes:
                prod = 1
                for a in axes:
                    prod *= self.mesh_shape[a]
                if prod == 0 or dim_sizes[i] % prod != 0:
                    axes = ()
            if not axes:
                out.append(None)
            else:
                used.update(axes)
                out.append(axes if len(axes) > 1 else axes[0])
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements(self, logical: Sequence[Optional[str]],
                   dim_sizes: Optional[Sequence[int]] = None) -> tuple:
        """One DTensor placement per mesh dim for ``logical``."""
        return spec_placements(self.pspec(logical, dim_sizes),
                               self.mesh_axes)

    def batch_axes(self) -> Tuple[str, ...]:
        return self._axes_for("batch")

    def batch_size(self) -> int:
        """The product of the mesh sizes of ``batch_axes()``."""
        n = 1
        for a in self.batch_axes():
            n *= self.mesh_shape[a]
        return n


def spec_placements(spec: tuple, mesh_axes: Sequence[str]) -> tuple:
    """A pspec tuple -> (Shard(i) | Replicate()) for each mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axes)


def make_rules(mesh, overrides: Optional[Dict[str, AxisVal]] = None
               ) -> AxisRules:
    """Rules over ``mesh``: a DeviceMesh, or anything with
    ``mesh_dim_names`` and ``shape``."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    names = tuple(mesh.mesh_dim_names)
    shape = dict(zip(names, tuple(mesh.shape)))
    return AxisRules(rules=rules, mesh_axes=names, mesh_shape=shape)


def tree_pspecs(decls, rules: AxisRules):
    """ParamDecl tree -> pspec tree (divisibility-aware)."""
    return tree_map(lambda d: rules.pspec(d.logical, d.shape), decls)


def tree_placements(decls, rules: AxisRules):
    """ParamDecl tree -> tree of per-mesh-dim placement tuples."""
    return tree_map(lambda d: rules.placements(d.logical, d.shape), decls)


def placement_leaves(pl, n: int) -> list:
    """The placement tuples of a ``tree_placements`` tree in leaf order
    (a placement tuple is a leaf here, not a node); None: ``n`` Nones."""
    if pl is None:
        return [None] * n
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list) or (isinstance(node, tuple) and node
                                        and isinstance(node[0],
                                                       (list, tuple, dict))):
            for v in node:
                walk(v)
        else:
            out.append(node)
    walk(pl)
    return out


def shard_of(t, mesh, placements):
    """This rank's shard of the whole tensor ``t`` under ``placements``
    on ``mesh`` (a slice: no communication), as a DTensor."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def local_shape(shape: Sequence[int], placements, mesh_shape) -> tuple:
    """The shard shape one rank holds (every sharded dim divides)."""
    out = list(shape)
    for p, n in zip(placements, mesh_shape):
        if p.is_shard():
            out[p.dim] //= n
    return tuple(out)


def constrain(x, rules: AxisRules, *logical: Optional[str]):
    """Redistribute a DTensor to the rules' placements for ``logical``;
    any other tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    want = rules.placements(logical, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# --- activation-constraint context -----------------------------------------
# Model code calls ``ac(x, *logical)``; the step builder installs the active
# rules while tracing. Outside any context this is a no-op, so the tests
# and the card's runs go unchanged (the reference's pattern).
_ACTIVE: list = []


class activation_rules:
    def __init__(self, rules: AxisRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def active_rules() -> Optional[AxisRules]:
    return _ACTIVE[-1] if _ACTIVE else None


def ac(x, *logical: Optional[str]):
    """Constrain an activation by logical axis names (no-op w/o context)."""
    if not _ACTIVE:
        return x
    return constrain(x, _ACTIVE[-1], *logical)


# --- shard-local regions -------------------------------------------------
# Where the plain path needs an op that has no DTensor sharding strategy
# (the cache writes at a position, the MoE's slot table, the attention
# kernels, which take plain tensors only), the model runs that region on
# each rank's shards, as a jax shard_map would: inputs redistributed to the
# layout the region needs, the region on the local tensors, the outputs
# wrapped back. Each helper returns at once on plain tensors.

def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _rules() -> AxisRules:
    rules = active_rules()
    if rules is None:
        raise RuntimeError("a DTensor reached a shard-local region outside "
                           "partition.activation_rules")
    return rules


def to_local(x, *logical: Optional[str]):
    """x's shard on this rank after redistributing it to the rules'
    placements for ``logical`` (no names: as it is); a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    if logical:
        x = constrain(x, _rules(), *logical)
    return x.to_local()


def from_local(t, like, shape, *logical: Optional[str]):
    """Wrap this rank's shard ``t`` of a tensor of global ``shape`` as a
    DTensor on ``like``'s mesh, with the rules' placements for
    ``logical``; plain ``like``: ``t`` as it is."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor
    rules = _rules()
    pl = rules.placements(logical, shape)
    mesh = like.device_mesh
    if local_shape(shape, pl, tuple(mesh.shape)) != tuple(t.shape):
        raise ValueError(f"shard {tuple(t.shape)} does not tile {shape} "
                         f"as {logical}")
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def heads_local(fn, q, k, v, *rest):
    """Attention ``fn(q, k, v, *rest) -> o`` on each rank's heads.

    q (B, Sq, H, D); k and v (B, Skv, KH, D), or a fused cache layer (B,
    Skv, KH*D). Batch shards over the batch axes; heads over ``model``
    where KH divides it; else q's heads shard where H divides and each
    rank's query heads read whole KV heads, and each rank keeps the KV
    heads they read; else heads replicate over ``model``. ``rest`` (a
    0-d length) is taken whole. ``fn`` gets k and v as (B, Skv, KH', D);
    on plain tensors, every head."""
    if not is_dtensor(q):
        D = q.shape[3]
        k, v = (t if t.dim() == 4 else t.view(*t.shape[:2], -1, D)
                for t in (k, v))
        return fn(q, k, v, *rest)
    rules = _rules()
    m = rules.mesh_shape.get("model", 1)
    H, D = q.shape[2], q.shape[3]
    KH = k.shape[2] if k.dim() == 4 else k.shape[2] // D
    G, hq = H // KH, H // m
    kv_split = KH % m == 0
    q_split = kv_split or (H % m == 0 and (hq % G == 0 or G % hq == 0))
    q_log = ("batch", None, "heads" if q_split else None, None)

    def kv(t):
        if t.dim() == 3:
            tl = to_local(t, "batch", None, "qkv" if kv_split else None)
            return tl.view(tl.shape[0], tl.shape[1], -1, D)
        return to_local(t, "batch", None, "heads" if kv_split else None,
                        None)

    ql, kl, vl = to_local(q, *q_log), kv(k), kv(v)
    if q_split and not kv_split:
        r = q.device_mesh.get_local_rank("model")
        lo, hi = r * hq // G, ((r + 1) * hq - 1) // G + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    o = fn(ql, kl, vl, *(to_local(t, *(None,) * t.dim()) if is_dtensor(t)
                         else t for t in rest))
    return from_local(o, q, q.shape, *q_log)


def write_local(fn, buf, src, *src_logical: Optional[str]):
    """``fn(buf, src)`` writes ``src`` into ``buf`` in place. On a DTensor
    ``buf``, ``src`` is first redistributed to the rules' placements for
    ``src_logical``, which must tile ``buf``'s shards, and ``fn`` writes
    each rank's shard."""
    if not is_dtensor(buf):
        fn(buf, src)
        return
    fn(buf.to_local(), to_local(src, *src_logical))


def local_region(fn, args, in_logical, outs):
    """``fn(*args)`` on each rank's shards, as a jax shard_map: each
    DTensor argument redistributed to the rules' placements for its
    logical names (``in_logical``, one tuple an argument), ``fn``'s
    outputs wrapped back, each by its (logical names, global shape) in
    ``outs``. Where no argument is a DTensor, ``fn(*args)``."""
    like = next((a for a in args if is_dtensor(a)), None)
    if like is None:
        return fn(*args)
    res = fn(*(to_local(a, *lg) for a, lg in zip(args, in_logical)))
    return tuple(from_local(o, like, shape, *lg)
                 for o, (lg, shape) in zip(res, outs))


def split_heads(t, n_heads: int, head_dim: int):
    """(..., n_heads * head_dim) -> (..., n_heads, head_dim). A DTensor
    whose last dim shards over ``model`` in pieces that cut a head (the
    head count does not divide the model dim) is gathered over ``model``
    first, as GSPMD would; every other dim keeps its placement."""
    if is_dtensor(t):
        rules = _rules()
        if n_heads % rules.mesh_shape.get("model", 1):
            from torch.distributed.tensor import Replicate
            keep = [Replicate() if p.is_shard(t.dim() - 1) else p
                    for p in t.placements]
            t = t.redistribute(t.device_mesh, keep)
    return t.reshape(*t.shape[:-1], n_heads, head_dim)


def merge_heads(t):
    """(..., n_heads, head_dim) -> (..., n_heads * head_dim). Where the
    head count does not divide the model dim (``split_heads`` gathered
    it), the merged dim stays whole over ``model``, and so does its
    gradient, which a backward view could not split either."""
    out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if is_dtensor(out):
        rules = _rules()
        if t.shape[-2] % rules.mesh_shape.get("model", 1):
            from torch.distributed.tensor import Replicate
            keep = [Replicate() if p.is_shard(out.dim() - 1) else p
                    for p in out.placements]
            out = out.redistribute(out.device_mesh, keep)
    return out
