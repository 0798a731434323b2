# Port of repro/roofline/hlo_analyzer.py (its cost conventions, lines
# 1-25): a walker over the ops one rank runs in place of a walk over
# post-optimization HLO text.
"""Per-chip cost of a traced step: FLOPs, HBM bytes, collective bytes.

``CostMode`` is a ``TorchDispatchMode`` entered around a step traced
under ``FakeTensorMode`` (no allocation). It sees every aten op that one
rank runs, at that rank's local shapes: an op with DTensor arguments is
handed on (``NotImplemented``) to DTensor's dispatch, whose redistribution
(functional collectives) and local ops then come back through the mode
on plain fake tensors. The shape computation DTensor's sharding
propagator runs on global shapes is not counted.

Conventions, the reference's:
  * FLOPs: matmuls and convolutions 2 * result * contracted; pointwise
    ops 1 per output element; reductions their operand's elements; other
    ops (copies, gathers, sorts, concatenations) 0.
  * HBM bytes: inputs plus outputs of every op that materialises; views
    cost 0. In eager every op reads and writes HBM, so this is the port's
    real traffic on the card, not a fused estimate. An indexed write in
    place (``index_copy_``, ``scatter_``, ...) costs twice the rows it
    writes, as the reference's dynamic-update-slice; an indexed read
    (``index``, ``embedding``, ``gather``) twice the rows it reads.
  * Collectives: operand bytes per kind (``all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``), each priced at the slowest link its group
    crosses (``roofline/analysis.py``).
  * A hand-written kernel (``kernels/``) has no aten op: on a fake tensor
    inside this mode its wrapper stands in for its launch with the
    kernel's own count (``kernels/launches.stand_in``).

Eager runs the layer loop unrolled, so the reference's while-loop
trip-count scaling has no counterpart here: every layer's ops are seen.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import launches

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot",
           "mv", "addmv", "_scaled_mm"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
           "prod", "var", "std", "var_mean", "std_mean", "norm",
           "linalg_vector_norm", "argmax", "argmin", "_softmax",
           "_log_softmax", "cumsum", "cumprod", "any", "all",
           "_softmax_backward_data", "_log_softmax_backward_data"}
_INDEX_READ = {"index", "embedding", "gather", "index_select",
               "take_along_dim"}
_INDEX_WRITE = {"index_copy_", "index_put_", "scatter_", "scatter_add_",
                "scatter_reduce_", "index_add_", "_index_put_impl_",
                "masked_scatter_"}
_CONV = {"convolution", "_convolution", "conv1d", "conv2d"}
# data movement: bytes, no FLOPs (a copy is tagged pointwise)
_MOVES = {"clone", "_to_copy", "copy_", "cat", "stack", "constant_pad_nd",
          "sort", "topk", "repeat", "flip", "roll", "one_hot", "fill_",
          "zero_", "zeros", "ones", "full", "arange", "scalar_tensor",
          "new_zeros", "new_ones", "new_full", "zeros_like", "ones_like",
          "full_like", "select_backward", "slice_backward",
          "embedding_dense_backward", "slice_scatter", "select_scatter",
          "index_put", "index_add", "scatter", "masked_fill",
          "masked_fill_", "scatter_add", "nonzero", "split_with_sizes_copy",
          "unbind_copy", "expand_copy", "bernoulli_", "normal_", "uniform_",
          "random_"} | _INDEX_READ | _INDEX_WRITE
# no bytes move: allocation without a write, metadata, host reads, and
# _unsafe_view (a view the dispatcher does not mark as one)
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like", "_local_scalar_dense", "detach", "alias",
               "lift_fresh", "lift_fresh_copy", "sym_size", "sym_stride",
               "sym_numel", "is_same_size", "_unsafe_view"}
_COLLECTIVES = {"all_reduce", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "broadcast"}
# the propagator's own shape runs on global fake tensors: not work
_PROPAGATOR = "_sharding_prop.py"
# frames that name no model source
_PLUMBING = ("/distributed/partition.py", "/roofline/", "/common/tree.py",
             "/launch/steps.py", "/launch/train.py")


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_s: float = 0.0          # collective seconds at each group's link

    def __iadd__(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.bytes += other.bytes
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v
        self.coll_s += other.coll_s
        return self


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _matmul_flops(name: str, args) -> float:
    """2 * result * contracted, from the operands' shapes (local, or a
    DTensor's global); a fused add (``addmm``, ``baddbmm``) uncounted."""
    a, b = (args[1], args[2]) if name.startswith(("add", "badd")) else \
        (args[0], args[1])
    rows = math.prod(a.shape[:-1])
    cols = b.shape[-1] if b.dim() > 1 else 1
    return 2.0 * rows * a.shape[-1] * cols


def _conv_flops(args, out) -> float:
    w = args[1]
    per_out = w.shape[1]
    for k in w.shape[2:]:
        per_out *= k
    return 2.0 * out.numel() * per_out


class CostMode(TorchDispatchMode):
    """Counts the ops of a traced step (see the module docstring).

    ``links``: group name -> bytes/s of the slowest link that group
    crosses (``analysis.group_links``); a collective on a group it does
    not list is priced at ``default_link``. ``attribute``: also keep a
    ``Cost`` per source (``by_source``): the innermost model function on
    the Python stack and the aten op, or ``backward/<op>`` for the
    autograd engine's ops. Also tracks the bytes alive in the storages the
    step creates (``peak_bytes``), and ``kernels``: stand-in launches by
    kernel name."""

    def __init__(self, links: Optional[Dict[str, float]] = None,
                 default_link: float = 1.0, attribute: bool = False):
        super().__init__()
        self.links = dict(links or {})
        self.default_link = default_link
        self.attribute = attribute
        self.total = Cost()
        self.by_source: Dict[str, Cost] = collections.defaultdict(Cost)
        self.kernels: Dict[str, int] = collections.Counter()
        self.unknown: Dict[str, int] = collections.Counter()
        self.n_ops = 0
        self.global_flops = 0.0      # matmul FLOPs at DTensors' shapes
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, list] = {}
        self._pinned = set()          # the arguments' storages

    def pin(self, tensors) -> None:
        """Storages that exist before the step (its arguments): a view of
        one allocates nothing."""
        for t in tensors:
            self._pinned.add(t.untyped_storage()._cdata)

    # -- entry ------------------------------------------------------------
    def __enter__(self):
        launches.add_stand_in_hook(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        launches.remove_stand_in_hook(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and _is_dtensor_type(t)
               for t in types):
            if func._opname in _MATMUL and self._source() is not None:
                self.global_flops += _matmul_flops(func._opname, args)
            return NotImplemented
        out = func(*args, **kwargs)
        source = self._source()
        if source is None:              # the sharding propagator's run
            return out
        self._count(func, args, kwargs, out, source)
        return out

    # -- bookkeeping --------------------------------------------------------
    def _source(self) -> Optional[str]:
        f = sys._getframe(2)
        model = None
        while f is not None:
            fn = f.f_code.co_filename
            if fn.endswith(_PROPAGATOR):
                return None
            if (model is None and "/repro_torch/" in fn
                    and not any(p in fn for p in _PLUMBING)):
                model = (fn.rsplit("/repro_torch/", 1)[1][:-3] + "."
                         + f.f_code.co_name)
                if not self.attribute:
                    return model
            f = f.f_back
        if model is None:
            node = torch._C._current_autograd_node()
            return "backward" if node is None else f"backward.{node.name()}"
        return model

    def _add(self, source: str, name: str, c: Cost) -> None:
        self.total += c
        if self.attribute:
            self.by_source[f"{source}/{name}"] += c

    def _track(self, out, args) -> None:
        ins = {id(a) for a in _tensors(args)}
        for t in _tensors(out):
            if id(t) in ins:
                continue
            try:
                key = t.untyped_storage()._cdata
                nb = t.untyped_storage().nbytes()
            except Exception:
                continue
            if key in self._pinned:
                continue
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [nb, 0]
                self.live_bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.kernels[name] += 1
        self.n_ops += 1
        self._add(self._source() or "kernel", f"kernel:{name}",
                  Cost(flops=flops, bytes=nbytes))

    # -- the cost rules -------------------------------------------------------
    def _count(self, func, args, kwargs, out, source: str) -> None:
        ns = func.namespace
        name = func._opname
        if ns == "prim":
            return
        self._track(out, args)
        if ns == "_c10d_functional":
            if name == "wait_tensor":
                return
            self.n_ops += 1
            kind = name.rstrip("_")
            if kind not in _COLLECTIVES:
                self.unknown[f"{ns}.{name}"] += 1
            ob = sum(_nbytes(t) for t in _tensors(args[:1]))
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         None)
            bw = self.links.get(group, self.default_link)
            outb = sum(_nbytes(t) for t in _tensors(out))
            self._add(source, kind, Cost(bytes=ob + outb,
                                         coll={kind: float(ob)},
                                         coll_s=ob / bw))
            return
        if func.is_view or name in _NO_TRAFFIC:
            return
        self.n_ops += 1
        outs = list(_tensors(out))
        ins, seen = [], set()
        for t in _tensors(list(args) + list(kwargs.values())):
            if id(t) not in seen:
                seen.add(id(t))
                ins.append(t)
        flops = 0.0
        if name in _MATMUL:
            flops = _matmul_flops(name, args)
        elif name in _CONV:
            flops = _conv_flops(args, outs[0])
        elif name in _REDUCE:
            flops = float(ins[0].numel())
        elif name in _MOVES:
            pass
        elif torch.Tag.pointwise in func.tags:
            flops = float(sum(t.numel() for t in outs))
        else:
            self.unknown[name] += 1
        if name in _INDEX_WRITE:
            nbytes = 2.0 * sum(_nbytes(t) for t in ins[1:])
        elif name in _INDEX_READ:
            nbytes = 2.0 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif name == "copy_":
            nbytes = float(_nbytes(args[0]) + _nbytes(args[1]))
        elif name in ("fill_", "zero_"):
            nbytes = float(_nbytes(args[0]))
        elif name.endswith("_") and ins and outs and outs[0] is ins[0]:
            # in place: the others read, self read and written
            nbytes = float(sum(_nbytes(t) for t in ins) + _nbytes(ins[0]))
        else:
            nbytes = float(sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        self._add(source, name, Cost(flops=flops, bytes=nbytes))


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)
