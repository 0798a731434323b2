# Port of repro/roofline/analysis.py: Roofline (its fields, properties and
# as_dict) and model_flops copied; analyze(cell) counts a traced step
# (roofline/cost.py) where the reference reads a compiled artifact.
"""Three-term roofline of a traced step, per chip.

  compute    = FLOPs_per_chip / peak FLOP/s
  memory     = HBM_bytes_per_chip / HBM bandwidth
  collective = sum over collectives of operand bytes / the bandwidth of
               the slowest link its group crosses

Hardware: one NVIDIA H100 SXM (80 GB HBM3) a rank, 8 a node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM datasheet: 989 TFLOP/s dense bf16 tensor core (1,979
# with sparsity), 3.35 TB/s HBM3, 80 GB.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# NVLink 4: 900 GB/s a GPU both ways, 450 GB/s a direction, within a
# node of 8 (HGX H100 8-GPU). Across nodes: one 400 Gb/s NDR InfiniBand
# adapter a GPU, 50 GB/s a direction.
NVLINK_BW = 450e9
NETWORK_BW = 50e9
GPUS_PER_NODE = 8


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    chips: int
    model_flops_global: float
    raw_cost_flops: float = 0.0
    raw_cost_bytes: float = 0.0
    n_hlo_warnings: int = 0
    coll_seconds: float = 0.0   # sum of each collective's bytes / its link

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_seconds

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Max-of-terms lower bound (perfect overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        counted_global = self.flops_per_chip * self.chips
        return self.model_flops_global / max(counted_global, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization achievable at the roofline bound."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops_global / (self.chips * PEAK_FLOPS * t)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_bound": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "raw_cost_flops": self.raw_cost_flops,
            "raw_cost_bytes": self.raw_cost_bytes,
            "n_hlo_warnings": self.n_hlo_warnings,
        }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D train, 2*N_active*D inference,
    plus exact-attention cache reads for decode."""
    n = cfg.active_params()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * B * S
    if shape.kind == "prefill":
        return 2.0 * n * B * S
    att = 4.0 * B * S * cfg.n_heads * cfg.hd if cfg.rwkv is None else 0.0
    return 2.0 * n * B + att


def group_links(mesh) -> Dict[str, float]:
    """Each mesh dim's process group -> the bandwidth of the slowest link
    it crosses: NVLink where all its ranks share a node of
    ``GPUS_PER_NODE``, else the network. Ranks fill nodes in order."""
    if mesh is None:
        return {}
    ranks = mesh.mesh
    out = {}
    for dim in range(ranks.dim()):
        group = mesh.get_group(dim)
        line = ranks.movedim(dim, -1).reshape(-1, ranks.shape[dim])[0]
        nodes = {int(r) // GPUS_PER_NODE for r in line}
        out[group.group_name] = NVLINK_BW if len(nodes) == 1 else NETWORK_BW
    return out


def roofline(trace, cfg, shape, chips: int) -> Roofline:
    """A ``steps.Trace``'s counts as a Roofline."""
    c = trace.cost
    return Roofline(
        flops_per_chip=c.flops,
        bytes_per_chip=c.bytes,
        coll_bytes_per_chip=float(sum(c.coll.values())),
        coll_breakdown={k: int(v) for k, v in c.coll.items()},
        chips=chips,
        model_flops_global=model_flops(cfg, shape),
        raw_cost_flops=trace.global_flops / max(chips, 1),
        raw_cost_bytes=0.0,
        n_hlo_warnings=sum(trace.unknown.values()),
        coll_seconds=c.coll_s,
    )


def analyze(cell) -> Roofline:
    """Trace ``cell`` (``launch/steps.Cell``) and count it."""
    return roofline(cell.trace(), cell.cfg, cell.shape, cell.chips)
