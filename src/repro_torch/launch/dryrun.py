# Port of repro/launch/dryrun.py: the same CLI and record keys; a cell is
# traced on a fake process group's production mesh (launch/mesh.py) and
# counted (roofline/) where the reference lowers and compiles it on 512
# forced host devices.
"""Production-mesh dry run: trace every (arch x shape x mesh) cell and
record its memory and three-term roofline per card (one H100 a rank).

Runs on the CPU, in one process that stands for rank 0 of a fake process
group of 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks; nothing is
allocated (``FakeTensorMode``) and nothing runs on a card. A record holds
``arch``, ``shape``, ``mesh``, ``params``, ``active_params`` and
``status`` (ok / skipped / error) with its ``reason`` (skipped) or
``error`` and ``traceback``; an ok record also ``optimizer`` (train
cells), ``t_trace_s``, ``memory`` per card (``argument_bytes`` exact from
the placements, ``output_bytes``, the trace's ``temp_peak_bytes`` and
``fits`` in 80 GB), ``kernels`` (stand-in launches by kernel) and
``roofline`` (``roofline/analysis.Roofline.as_dict``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --mesh both --arch all --shape all --out runs/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.steps import build_cell, default_optimizer
from repro_torch.roofline import analysis

MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             optimizer=None, rule_overrides=None, tp_pad: bool = False
             ) -> dict:
    """One cell's record. The process group is made (or remade) the
    mesh's fake world where it is not that already."""
    cfg = get_config(arch)
    if tp_pad:
        cfg = cfg.tp_friendly(16)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    name, world = MESHES[multi_pod]
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "params": cfg.n_params(), "active_params": cfg.active_params()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        ensure_world(world)
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell = build_cell(cfg, shape, mesh, optimizer=optimizer,
                          rule_overrides=rule_overrides)
        trace = cell.trace()
        roof = analysis.roofline(trace, cell.cfg, shape, cell.chips)
        rec.update(
            status="ok",
            optimizer=(optimizer or default_optimizer(cfg))
            if shape.kind == "train" else None,
            t_trace_s=round(trace.t_trace_s, 2), memory=trace.memory(),
            kernels=trace.kernels, roofline=roof.as_dict())
    except Exception as e:  # record the failure; these are faults to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-2000:])
    return rec


def ensure_world(world: int) -> None:
    """Make this process rank 0 of a fake group of ``world`` ranks, unless
    it is already."""
    import torch.distributed as dist
    if not (dist.is_initialized() and dist.get_world_size() == world):
        init_fake_world(world)
    # DTensor warns at each multi-step redistribution; the counts are the
    # record, not the warnings
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun_torch.json")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--tp-pad", action="store_true",
                    help="apply ArchConfig.tp_friendly (head padding + KV "
                         "replication) before tracing")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    t_start = time.time()
    for multi in meshes:            # one fake world at a time
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}|{shape_name}|{'multi' if multi else 'single'}"
                if (args.skip_existing
                        and results.get(key, {}).get("status") == "ok"):
                    continue
                print(f"=== {key}", flush=True)
                rec = run_cell(arch, shape_name, multi,
                               optimizer=args.optimizer, tp_pad=args.tp_pad)
                results[key] = rec
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" t=({r['t_compute']:.2e},{r['t_memory']:.2e},"
                             f"{r['t_collective']:.2e})s"
                             f" trace={rec['t_trace_s']}s")
                elif status == "error":
                    extra = " " + rec["error"][:200]
                print(f"    -> {status}{extra}", flush=True)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {args.out}"
          f" ({time.time() - t_start:.0f} s)")


if __name__ == "__main__":
    main()
