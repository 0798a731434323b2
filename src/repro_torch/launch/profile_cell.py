# Port of repro/launch/profile_cell.py: the roofline terms and the top
# cost contributors of one cell; on --device cuda and a one-device mesh,
# also the cell run for real on the card and measured against its bound.
"""Profile one cell: roofline terms, top cost contributors, and (on a
card) the measured step.

  PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
      --arch deepseek-v3-671b --shape decode_32k [--multi] [--optimizer ..]
  PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
      --arch qwen3-8b --shape decode_32k --one --batch 8 --device cuda

``--one`` traces the cell on one device (no mesh) instead of a
production mesh (``--multi``: 512 ranks, else 256). ``--batch`` and
``--seq`` cut the shape to fit one card; the cuts are printed. On
``--device cuda`` (one device only) the cell also runs on the card:
median ms a step by CUDA events, torch.profiler's top kernels by device
time and the busy share (their device time over the profiled step's
wall time), and ``roofline_share``: the trace's ``step_time_bound``
over the measured step. A decode cell's cache is first filled with
seeded K/V to ``--cur-len`` (default: its capacity minus one), and each
timed step starts from that length.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import zlib
from typing import Optional

import torch

from repro_torch.common.tree import leaves_with_paths
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.steps import build_cell
from repro_torch.roofline import analysis
from repro_torch.roofline.attribution import top_costs


def fill_cache(cache, cur_len: int, seed: int = 0) -> None:
    """Seeded N(0, 1) K/V (every floating leaf of the cache's segments)
    in the first ``cur_len`` positions, zeros past them, and
    ``cache["len"] = cur_len``; a layer at a time, in place."""
    for path, t in leaves_with_paths(cache["segments"]):
        if not t.is_floating_point() or t.dim() < 4:
            continue
        g = torch.Generator(device=t.device).manual_seed(
            seed + zlib.crc32(path.encode()))
        for layer in t:                               # (B, S, F)
            layer[:, :cur_len].copy_(torch.randn(
                layer[:, :cur_len].shape, generator=g, device=t.device))
            layer[:, cur_len:].zero_()
    restart(cache, cur_len)


def restart(cache, cur_len: int) -> None:
    """Set a decode cache's length back to ``cur_len`` (a new tensor: the
    last step made ``len`` inside inference mode)."""
    cache["len"] = torch.full((), cur_len, dtype=torch.int32,
                              device=cache["len"].device)


def step_fn(cell, args, cur_len: Optional[int]):
    """One step of the cell on ``args`` (a decode step restarting at
    ``cur_len``)."""
    def step():
        if cur_len is not None:
            restart(args[1], cur_len)
        return cell.run(*args)
    return step


def measure(cell, args, *, reps: int = 5, cur_len: Optional[int] = None
            ) -> dict:
    """Median ms a step over ``reps`` steps (after one warm-up), each
    between two CUDA events."""
    step = step_fn(cell, args, cur_len)
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cur_len is not None:
            restart(args[1], cur_len)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cell.run(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "ms_all": times}


def profile_kernels(cell, args, *, top: int = 10,
                    cur_len: Optional[int] = None, attempts: int = 3,
                    step_ms: Optional[float] = None) -> dict:
    """torch.profiler over one step: the ``top`` kernels by device time
    (name, ms, calls), the device time of all kernels, the profiled
    step's wall time, and the busy share: device time over ``step_ms``
    (a step timed without the profiler, whose own host work stretches the
    profiled step), else over the profiled wall time. The profiler's
    trace now and then holds no kernels: the step is profiled again, up
    to ``attempts`` in all (``attempts`` says how many it took)."""
    from torch.profiler import ProfilerActivity, profile
    step = step_fn(cell, args, cur_len)
    torch.cuda.synchronize()
    rows = []
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            rows.append({"name": ev.key[:120], "ms": us / 1e3,
                         "calls": ev.count})
        if rows:
            break
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    return {"top": rows[:top], "device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / (step_ms or wall_ms),
            "n_kernels": sum(r["calls"] for r in rows),
            "attempts": attempt + 1}


def one_device_cell(arch: str, shape_name: str, *, batch=None, seq=None,
                    optimizer=None):
    """(the one-device cell, the cuts made to its shape)."""
    shape = SHAPES[shape_name]
    cell = build_cell(get_config(arch), shape, None, optimizer=optimizer,
                      batch=batch, seq=seq)
    cuts = {k: [full, cut] for k, full, cut in (
        ("batch", shape.global_batch, cell.batch),
        ("seq", shape.seq_len, cell.seq)) if full != cut}
    return cell, cuts


def run_on_card(cell, *, reps: int = 5, top: int = 10, seed: int = 0,
                cur_len: Optional[int] = None, roof=None) -> dict:
    """The cell on the card: arguments made there, measured, profiled;
    ``roof``: the cell's Roofline, for ``roofline_share``."""
    args = list(cell.init_args("cuda", seed))
    if cell.shape.kind == "decode":
        cur_len = cell.seq - 1 if cur_len is None else cur_len
        fill_cache(args[1], cur_len, seed)
    else:
        cur_len = None
    m = measure(cell, args, reps=reps, cur_len=cur_len)
    prof = profile_kernels(cell, args, top=top, cur_len=cur_len,
                           step_ms=m["ms"])
    out = {"measured_ms": m["ms"], "measured_ms_all": m["ms_all"],
           "cur_len": cur_len, "profile": prof}
    if roof is not None:
        out["roofline_share"] = roof.step_time / (m["ms"] / 1e3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--one", action="store_true",
                    help="one device instead of a production mesh")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--cur-len", type=int, default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.device == "cuda" and not args.one:
        ap.error("--device cuda runs a one-device cell: pass --one")

    if args.one:
        cell, cuts = one_device_cell(args.arch, args.shape,
                                     batch=args.batch, seq=args.seq,
                                     optimizer=args.optimizer)
        mesh_name = "one"
    else:
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        mesh_name, world = dryrun.MESHES[args.multi]
        dryrun.ensure_world(world)
        cell = build_cell(get_config(args.arch), SHAPES[args.shape],
                          make_production_mesh(multi_pod=args.multi),
                          optimizer=args.optimizer, batch=args.batch,
                          seq=args.seq)
        cuts = {}
    trace = cell.trace()
    roof = analysis.roofline(trace, cell.cfg, cell.shape, cell.chips)
    print(f"=== {args.arch} | {args.shape} | {mesh_name}"
          + (f" | cut {cuts}" if cuts else ""))
    for k, v in roof.as_dict().items():
        print(f"  {k}: {v}")
    mem = trace.memory()
    print(f"  temp_GB: {mem['temp_peak_bytes']/1e9:.1f}  "
          f"args_GB: {mem['argument_bytes']/1e9:.1f}  fits: {mem['fits']}")
    print(f"  kernels: {trace.kernels}  trace_s: {trace.t_trace_s:.1f}")
    print(top_costs(cell, k=args.top))
    if args.device == "cuda":
        card = run_on_card(cell, reps=args.reps, top=min(args.top, 10),
                           cur_len=args.cur_len, roof=roof)
        print(json.dumps(card))


if __name__ == "__main__":
    main()
