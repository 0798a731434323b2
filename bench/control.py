"""Readings of the numbers that decide ``correct``, for setting their
limits: the program's and the control's, over many seeds, in one process.

  python3 bench/control.py --workload <cell> --seeds 1 2 3 [--control]
      [--faults] [--kernels-only] [--out readings.jsonl]

For each seed this sets the cell up as a run does (the weights and the
documents from the seed), runs one batch of the window through the timed
path at the cell's own sizes, and compares it with the architecture's
float32 reference (``compare.readings``): the program's reading. With
``--control`` it also reads the control: the reference put in the
program's place and computed one precision below the configuration's
bfloat16, every product's operands in float8 e4m3 (``precision="fp8"``;
``reference.transformer.Products``), scored with
the plain scores one precision below the scoring kernel's float32, in
bfloat16, and plain attention with float8 operands in the attention
kernels' place. With ``--faults`` it reads each fault of
``bench/faults.py`` that the cell can have, planted in the same batch at
the same sizes, and for a MoE a wrong expert and a wrong slot planted in
the routes the reference follows. ``--kernels-only`` reads the attention
kernels' numbers alone (``compare.kernels``), without the model's
float32 forward. A line of JSON a seed, on standard output and, with
``--out``, appended to that file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def _batch(sweep, prompts, fed, sync):
    """One batch through the timed path: (logits (B, 1 + steps, V') on
    the host, so that the runs of a seed do not add up on the card,
    scores, routes, one layer's attention)."""
    import torch
    logits, steps, scores = sweep.run_batch(prompts, fed, sync)
    sync()
    return (torch.stack([logits] + list(steps), 1).cpu(), scores,
            sweep.routes(), sweep.attn)


def readings(layout, workload: str, seed: int, control: bool,
             faults: bool = False, device="cuda", model: bool = True) -> dict:
    import torch
    from bench import compare, faults as faults_lib, harness
    from bench.reference.scores import KINDS, scores as plain_scores

    cell = layout.cell(workload)
    t0 = time.perf_counter()
    sweep = harness.Sweep(layout, cell, seed, device)
    reference = sweep.arch.reference
    t = sweep.traffic
    toks, prompts, fed = sweep.inputs(0)

    def sync():
        if sweep.device.type == "cuda":
            torch.cuda.synchronize(sweep.device)

    try:
        runs = {"program": _batch(sweep, prompts, fed, sync)}
        t1 = time.perf_counter()
        if faults:
            for plant in faults_lib.for_cell(t):
                undo = plant(sweep)
                try:
                    runs[plant.__name__] = _batch(sweep, prompts, fed, sync)
                finally:
                    undo()
    finally:
        sweep.close()
    sweep.free()
    if sweep.device.type == "cuda":
        torch.cuda.empty_cache()
    tokens = torch.from_numpy(toks).to(sweep.device)
    dense_ref = []

    def ref_following(forced):
        """The float32 reference, following ``forced`` routes (a MoE);
        a dense stack's is the same for every run of the batch."""
        if forced is None and dense_ref:
            return dense_ref[0], None
        routing = None if forced is None else reference.Routing(forced)
        ref = reference.forward(sweep.conf, sweep.params, tokens,
                                t.prompt_len, routing=routing)
        if forced is None:
            dense_ref.append(ref)
        return ref, routing

    out = {"workload": workload, "seed": seed, "batch_s": t1 - t0}
    for name, (port, scores, routes, attn) in runs.items():
        out[name] = compare.kernels(attn)
        if not model:
            continue
        t2 = time.perf_counter()
        ref, routing = ref_following(routes)
        out[name].update(compare.readings(port.to(ref.device), scores,
                                          ref, routing))
        if routing is not None:
            out[name + "_flips"] = routing.flips
        sync()
        out[name + "_reference_s"] = time.perf_counter() - t2
    port, scores, routes, attn = runs["program"]
    if not model:
        if control:
            out["control"] = compare.kernels(attn, precision="fp8")
        del sweep, runs
        if device == "cuda":
            torch.cuda.empty_cache()
        return out
    if faults and routes is not None:
        args = (t.scored_steps, sweep.conf["n_routed_experts"],
                sweep.conf["assumed"]["capacity_factor"], reference)
        for plant in (faults_lib.wrong_expert, faults_lib.wrong_slot):
            ref, routing = ref_following(plant(routes, *args))
            out[plant.__name__] = compare.readings(port.to(ref.device),
                                                   scores, ref, routing)
            out[plant.__name__].update(compare.kernels(attn))
    if control:
        t2 = time.perf_counter()
        low_routing = reference.Routing()
        low = reference.forward(sweep.conf, sweep.params, tokens,
                                t.prompt_len, precision="fp8",
                                routing=low_routing)
        plain = plain_scores(low[:, 1:].reshape(-1, low.shape[-1]),
                             dtype=torch.bfloat16)
        B = t.batch
        low_scores = torch.stack([plain[k].reshape(B, -1).T
                                  for k in KINDS]).float()
        ref, routing = ref_following(None if routes is None
                                     else low_routing.own)
        if routing is not None:
            out["control_flips"] = routing.flips
        out["control"] = compare.readings(low, low_scores, ref, routing)
        out["control"].update(compare.kernels(attn, precision="fp8"))
        sync()
        out["control_s"] = time.perf_counter() - t2
    del sweep, runs, dense_ref
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from bench import harness
    layout = harness.Layout(ROOT)
    for seed in args.seeds:
        line = json.dumps(readings(layout, args.workload, seed, args.control,
                                   args.faults,
                                   model=not args.kernels_only))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
