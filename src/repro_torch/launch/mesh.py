# Port of repro/launch/mesh.py: the debug half (make_debug_mesh((n,),
# ("data",))) as spawned ranks, and the production half
# (make_production_mesh, :27-37) over a fake process group.
"""A debug mesh of ``world`` ranks over one ``data`` axis: ``world``
processes, each in a ``torch.distributed`` process group.

The reference builds a one-axis mesh over forced host devices and runs
``shard_map`` programs on it. Here each rank is a process started with
the ``spawn`` method (never ``fork``: the caller may hold a live CUDA
context), its group initialised over ``tcp://localhost:<free port>``
with the caller's backend. ``run_debug_mesh(fn, world, *args)`` calls
``fn(rank, world, group, device, *args)`` on every rank and returns the
results in rank order; ``fn`` and ``args`` must pickle, and so must the
results (CPU tensors, numpy arrays, numbers); a spawned rank starts with
the caller's ``sys.path``, and a function of a script run as ``__main__``
needs the script's ``if __name__ == "__main__"`` guard. A rank that
raises fails the whole call with its traceback, and so does a mesh
where no rank answers within ``TIMEOUT_S``. ``device`` names each rank's
device: ``"cuda"`` (the default: every rank on ``cuda:0``; NCCL refuses
two ranks on one card, so more than one rank there needs ``"gloo"``), or
``"cpu"``.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

JOIN_S = 60
TIMEOUT_S = 600      # a collective's and the parent's wait for a rank


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, fn, args, out):
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            dev = torch.device(device)
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            if dev.type == "cuda":
                dev = torch.device("cuda", dev.index or 0)
                torch.cuda.set_device(dev)
            # by value: a tensor sent as is would share its storage with
            # a process that exits
            out.put((rank, True, pickle.dumps(
                fn(rank, world, dist.group.WORLD, dev, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_debug_mesh(fn: Callable, world: int, *args, backend: str = "gloo",
                   device="cuda") -> List[Any]:
    """Run ``fn(rank, world, group, device, *args)`` on ``world`` spawned
    ranks; returns their results in rank order."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, str(device), fn,
                               args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, []
    try:
        while len(results) + len(failed) < world:
            try:
                rank, ok, val = out.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"debug mesh: no rank answered in "
                                   f"{TIMEOUT_S} s") from None
            if ok:
                results[rank] = pickle.loads(val)
            else:
                failed.append((rank, val))
                break
    finally:
        for p in procs:
            p.join(JOIN_S if not failed else 5)
            if p.is_alive():
                p.kill()
                p.join(JOIN_S)
    if failed:
        rank, tb = failed[0]
        raise RuntimeError(f"debug mesh rank {rank} failed:\n{tb}")
    return [results[r] for r in range(world)]


# ------------------------------------------------------- production mesh ---
# The reference's production meshes: (16, 16) ("data", "model"), 256
# chips, and (2, 16, 16) ("pod", "data", "model"), 512 chips. On H100s
# these are 32 or 64 nodes of 8 cards. The dry run builds them over a
# *fake* process group (``torch.testing._internal.distributed.fake_pg``):
# one process stands for rank 0 of the world, its collectives return at
# once, and a step is traced on it, never run.

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks, replacing any group it has. Raises ImportError where this
    torch has no fake backend."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """The production DeviceMesh over the process group's world, which
    must be 256 ranks (single pod) or 512 (multi pod): a smaller world is
    never taken for one. The mesh's device type is ``cpu``: the dry run
    traces fake CPU tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"need a world of {need} ranks, have {have}: call "
            f"init_fake_world({need}) first (launch.dryrun does)")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)
