# Port of repro/distributed/elastic.py:22-51: largest_mesh_shape (the same
# errors), make_elastic_mesh over the process group's world, reshard_plan
# (placements in place of shardings).
"""Elastic scaling: rebuild the mesh from whatever ranks exist and reshard
state onto it.

With whole-leaf checkpoints (``checkpoint/manager.py``), scale-up/down
is: detect the world change -> ``make_elastic_mesh()`` -> re-derive the
placements from the same logical rules (``reshard_plan``) ->
``restore(template, placements=...)`` -> continue.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.distributed import partition


def largest_mesh_shape(n_devices: int, model_parallel: int = 1
                       ) -> Tuple[int, int]:
    """(data, model) using as many devices as divisibility allows.

    ``model_parallel`` is clamped down to the largest divisor of
    ``n_devices``; both arguments must be >= 1 (0 would divide by zero,
    negatives would walk the divisor search forever)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    model = min(model_parallel, n_devices)
    while n_devices % model != 0:
        model -= 1
    return n_devices // model, model


def make_elastic_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """A ("data", "model") DeviceMesh over every rank of the process
    group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    data, model = largest_mesh_shape(dist.get_world_size(), model_parallel)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def reshard_plan(decls, mesh, overrides=None):
    """(placements tree, rules) for ``mesh`` from the shared rules."""
    rules = partition.make_rules(mesh, overrides)
    return partition.tree_placements(decls, rules), rules
