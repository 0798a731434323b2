# Port of repro/launch/mesh.py's debug half (make_debug_mesh((n,),
# ("data",))); make_production_mesh waits for ROADMAP A13's tooling slice.
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
