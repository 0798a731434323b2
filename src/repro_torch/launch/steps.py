# Port of repro/launch/steps.py:23-164: data_specs, data_pspecs,
# default_optimizer, Cell and build_cell, on a torch DeviceMesh with
# DTensor placements; Cell.trace (FakeTensorMode, no allocation) takes the
# place of lowering against ShapeDtypeStructs, and Cell.run runs a
# one-device cell for real.
"""Step builders and input specs for every (arch x shape) cell.

``build_cell(cfg, shape, mesh)`` declares a cell's arguments (params,
optimizer state, batch, cache) as ``ParamDecl`` trees and resolves their
placements from the logical-axis rules (``distributed/partition.py``).
Its step is the port's own: ``train_step`` (``Model.loss``, its
gradient, ``opt.update``; ``launch/train.make_train_step``),
``prefill_step`` (``Model.prefill``) and ``serve_step``
(``Model.decode_step``), the serving steps on the kernel path
(``attention_impl="pallas"``), as the card serves.

``mesh`` is a DeviceMesh (a fake process group's for the production
meshes, ``launch/mesh.py``) or None for one device. On a mesh, each
argument is a DTensor with its rules' placements and the step runs under
``partition.activation_rules`` and DTensor's implicit replication (a
plain tensor the model makes, a position range, is replicated). On one
device every placement is ``Replicate`` and the step takes plain tensors,
so that the kernels get plain tensors.

``Cell.trace()`` builds the arguments as fake tensors (each rank's shard
of a DTensor) and runs the step under ``FakeTensorMode`` inside
``roofline.cost.CostMode``, on the CPU: no memory is allocated, and the
kernels stand in for their launches. ``Cell.run(*args)`` runs the step
on real tensors (``Cell.init_args``), one device only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.common.param import ParamDecl, init_params, is_decl
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import partition
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.roofline import analysis, cost


def data_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, ParamDecl]:
    """Declarations of the host-data inputs of a cell (batch-sharded)."""
    B, S = shape.global_batch, shape.seq_len
    tok = dict(logical=("batch", None), init="zeros", dtype=torch.int32)
    if shape.kind == "train":
        out = {"tokens": ParamDecl((B, S), **tok),
               "labels": ParamDecl((B, S), **tok)}
    elif shape.kind == "prefill":
        out = {"tokens": ParamDecl((B, S), **tok)}
    else:  # decode
        out = {"token": ParamDecl((B, 1), **tok)}
    emb = dict(logical=("batch", None, None), init="zeros",
               dtype=torch.bfloat16)
    if cfg.enc_dec and shape.kind != "decode":
        out["frames"] = ParamDecl((B, cfg.n_enc_frames, cfg.d_model), **emb)
    if cfg.n_patches and shape.kind != "decode":
        out["patch_embeds"] = ParamDecl((B, cfg.n_patches, cfg.d_model),
                                        **emb)
    return out


def data_pspecs(cfg: ArchConfig, shape: ShapeConfig,
                rules: partition.AxisRules) -> Dict[str, tuple]:
    return partition.tree_pspecs(data_specs(cfg, shape), rules)


def default_optimizer(cfg: ArchConfig) -> str:
    # fp32 Adam state for 671B params does not fit the chips' HBM at 512
    # chips; the factored optimizer does
    return "adafactor" if cfg.n_params() > 5e10 else "adamw"


@dataclasses.dataclass
class Trace:
    """What one traced step costs one rank."""
    cost: cost.Cost
    by_source: Dict[str, cost.Cost]
    kernels: Dict[str, int]
    unknown: Dict[str, int]
    global_flops: float
    argument_bytes: int
    output_bytes: int
    temp_peak_bytes: int
    n_ops: int
    t_trace_s: float

    def memory(self) -> dict:
        need = self.argument_bytes + self.temp_peak_bytes
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_peak_bytes": self.temp_peak_bytes,
                "fits": need <= analysis.HBM_BYTES}


@dataclasses.dataclass
class Cell:
    """Everything needed to trace or run one (arch x shape) on one mesh."""
    cfg: ArchConfig
    shape: ShapeConfig
    mesh: Any                       # DeviceMesh, or None: one device
    rules: Optional[partition.AxisRules]
    model: Model
    opt: Any                        # the optimizer of a train cell
    arg_decls: tuple                # ParamDecl trees, the step's arguments
    batch: int                      # the batch the cell was built at
    seq: int

    @property
    def chips(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size() > 1

    def placements(self):
        """Per argument, a tree of per-mesh-dim placement tuples (None on
        one device)."""
        if not self.sharded:
            return None
        return tuple(partition.tree_placements(d, self.rules)
                     for d in self.arg_decls)

    def _local(self, d: ParamDecl, pl) -> tuple:
        if pl is None:
            return tuple(d.shape)
        return partition.local_shape(d.shape, pl, tuple(self.mesh.shape))

    def argument_bytes(self) -> int:
        """Bytes of the arguments one rank holds, exact from the
        placements."""
        pls = self.placements() or (None,) * len(self.arg_decls)
        total = 0
        for decls, pl in zip(self.arg_decls, pls):
            ds = tree_leaves(decls)
            for d, p in zip(ds, partition.placement_leaves(pl, len(ds))):
                total += math.prod(self._local(d, p)) * d.held.itemsize
        return total

    # -- arguments --------------------------------------------------------
    def _make(self, d: ParamDecl, pl, factory):
        t = factory(self._local(d, pl), d)
        if pl is None:
            return t
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, pl, run_check=False,
                                  shape=torch.Size(d.shape),
                                  stride=partition._contiguous_stride(
                                      d.shape))

    def _args(self, factory):
        pls = self.placements() or (None,) * len(self.arg_decls)
        out = []
        for decls, pl in zip(self.arg_decls, pls):
            ds = tree_leaves(decls)
            leaves = [self._make(d, p, factory) for d, p in
                      zip(ds, partition.placement_leaves(pl, len(ds)))]
            out.append(_unflatten(decls, leaves))
        if self.shape.kind == "train":
            for t in tree_leaves(out[0]):
                t.requires_grad_(True)
        return tuple(out)

    def fake_args(self):
        """The arguments as fake tensors (call inside a FakeTensorMode):
        each rank's shard, wrapped as a DTensor on a mesh."""
        return self._args(lambda shape, d: torch.empty(
            shape, dtype=d.held, device="cpu"))

    def init_args(self, device="cuda", seed: int = 0):
        """Real arguments on one device: weights from ``Model.init``
        (seeded), the optimizer's zero state, zero caches, and token ids
        drawn from a generator seeded ``seed + 1``."""
        if self.sharded:
            raise ValueError("init_args runs one device only")
        device = torch.device(device)
        params = self.model.init(seed, device)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        V = self.cfg.vocab

        def data(d):
            if d.held == torch.int32:
                return torch.randint(0, V, d.shape, generator=g,
                                     device=device, dtype=torch.int32)
            return torch.randn(d.shape, generator=g, device=device).to(
                d.held)
        if self.shape.kind == "train":
            for t in tree_leaves(params):
                t.requires_grad_(True)
            return (params, self.opt.init(params),
                    tree_map(data, self.arg_decls[2]))
        if self.shape.kind == "prefill":
            return (params, tree_map(data, self.arg_decls[1]),
                    init_params(self.arg_decls[2], None, device))
        return (params, init_params(self.arg_decls[1], None, device),
                data(self.arg_decls[2]))

    # -- the step -------------------------------------------------------------
    def step(self, *args):
        """The cell's step on ``args``: (params, opt_state, batch) ->
        (params, opt_state, metrics); (params, batch, cache) -> (cache,
        logits); (params, cache, token) -> (logits, cache)."""
        kind = self.shape.kind
        if kind == "train":
            return make_train_step(self.model, self.opt)(*args)
        if self.sharded:
            # inference mode refuses DTensor views: no_grad serves the same
            with torch.no_grad():
                if kind == "prefill":
                    return Model.prefill.__wrapped__(self.model, *args)
                return Model.decode_step.__wrapped__(self.model, *args)
        if kind == "prefill":
            return self.model.prefill(*args)
        return self.model.decode_step(*args)

    def _context(self):
        stack = contextlib.ExitStack()
        if self.sharded:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(partition.activation_rules(self.rules))
            stack.enter_context(implicit_replication())
        return stack

    def run(self, *args):
        """The step on real tensors (one device)."""
        if self.sharded:
            raise ValueError("a sharded cell is traced, not run")
        return self.step(*args)

    def trace(self, *, attribute: bool = False) -> Trace:
        """The step on fake arguments, counted (``roofline.cost``)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        links = analysis.group_links(self.mesh if self.sharded else None)
        mode = cost.CostMode(links=links, default_link=analysis.NETWORK_BW,
                             attribute=attribute)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = self.fake_args()
            mode.pin(_local(t) for t in tree_leaves(args))
            with self._context(), mode:
                out = self.step(*args)
            out_bytes = sum(_local_bytes(t) for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
            del out, args
        return Trace(cost=mode.total, by_source=dict(mode.by_source),
                     kernels=dict(mode.kernels), unknown=dict(mode.unknown),
                     global_flops=mode.global_flops,
                     argument_bytes=self.argument_bytes(),
                     output_bytes=out_bytes,
                     temp_peak_bytes=mode.peak_bytes, n_ops=mode.n_ops,
                     t_trace_s=time.time() - t0)


def _local(t):
    return t.to_local() if partition.is_dtensor(t) else t


def _local_bytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _unflatten(decls, leaves):
    it = iter(leaves)

    def build(node):
        if is_decl(node):
            return next(it)
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        return [build(v) for v in node]
    return build(decls)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
               optimizer: Optional[str] = None,
               rule_overrides: Optional[dict] = None, *,
               batch: Optional[int] = None, seq: Optional[int] = None
               ) -> Cell:
    """The cell of ``cfg`` at ``shape`` on ``mesh`` (None: one device).
    ``batch``/``seq`` cut the shape's global batch and sequence (a cell
    cut to fit one card); the serving cells take the kernel path."""
    B = batch or shape.global_batch
    S = seq or shape.seq_len
    if (B, S) != (shape.global_batch, shape.seq_len):
        shape = dataclasses.replace(shape, global_batch=B, seq_len=S)
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, attention_impl="pallas")
    rules = (partition.make_rules(mesh, rule_overrides)
             if mesh is not None else None)
    model = Model(cfg)
    p_decls = model.param_decls()
    d_decls = data_specs(cfg, shape)
    opt = None
    if shape.kind == "train":
        opt = make_optimizer(optimizer or default_optimizer(cfg))
        args = (p_decls, opt.state_decls(p_decls), d_decls)
    else:
        c_decls = model.cache_decls(B, S)
        args = ((p_decls, d_decls, c_decls) if shape.kind == "prefill"
                else (p_decls, c_decls, d_decls["token"]))
    return Cell(cfg, shape, mesh, rules, model, opt, args, B, S)
