"""One traced run of a benchmark cell, read through the port's spans.

  python3 scripts/span_report.py --workload <cell> --seed <n> --seconds <s>
      [--out <file>.json]

Runs the cell as ``bench/run.py --trace 1`` does (``bench.harness.run``)
on the GPU, keeps the profiler's trace, and prints as its last line one
JSON object with the run's result line (``line``) and what the per-layer
metrics do not say (``bench.spans``):

- ``placed_s``: the window's device seconds by how they were placed (by
  launch, by neighbours, launched outside every span, unplaced), and
  ``in_roots_s``: the same for the operations placed within a
  ``model.prefill`` or ``serve.step`` span;
- ``decode_idle_s``: the decode's idle gaps by the program span of the
  launch that ended each;
- ``ffn_split_s``: the device seconds within ``layer.ffn`` by
  ``moe.route``, ``moe.dispatch``, ``moe.combine``, the products
  (``ffn_gemm_share.KERNELS``) and the rest, and ``ffn_kernels_s``, the
  kernels there that take most time, each marked where the name list
  counts it as a product;
- ``b4_in_steps``: the B4 launches (the runtime's clock) that lie inside
  a ``serve.step`` record (``time.time_ns``), and all of them;
- ``span_us``: the recorder's cost a span on this host, off and with a
  profiler recording, in the fresh process and after the run (its
  trace held).
"""
import argparse
import collections
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def span_cost_us(n: int = 4_000, reps: int = 5) -> dict:
    """Microseconds a span, with the recorder off and on: the least and
    the median of ``reps`` loops of ``n`` spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common import spans

    def per_span():
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in itertools.repeat(None, n):
                with spans.span("cost.probe"):
                    pass
            out.append(1e6 * (time.perf_counter() - t0) / n)
        return [min(out), statistics.median(out)]

    off = per_span()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        on = per_span()
    spans.clear()
    return {"off": off, "on": on}


def b4_in_steps(tr, steps) -> list:
    """[B4 launches inside a ``serve.step`` record, all B4 launches the
    trace holds]: the runtime's clock against the records'."""
    times = [tr.launches[op[3]] for op in tr.ops
             if "uncertainty_stats_split_kernel" in op[0]
             and op[3] in tr.launches]
    inside = sum(any(r.start_ns <= t <= r.end_ns for r in steps)
                 for t in times)
    return [inside, len(times)]


def ffn_split(placed, kernels) -> tuple:
    parts = collections.Counter()
    names = collections.Counter()
    for op, sid, _ in placed.ops:
        chain = [placed.spans[s].name for s in placed.chain(sid)]
        if "layer.ffn" not in chain:
            continue
        t = (op[2] - op[1]) / 1e9
        gemm = any(k in op[0] for k in kernels)
        moe = next((n for n in chain if n.startswith("moe.")), None)
        parts[moe or ("products" if gemm else "rest")] += t
        names[(op[0][:100], gemm)] += t
    top = [[n, g, t] for (n, g), t in names.most_common(15)]
    return dict(parts.most_common()), top


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from bench import harness, spans, trace as trace_lib
    from bench.metrics import ffn_gemm_share

    kept = {}
    read = trace_lib.read

    def keep(prof):
        kept["trace"] = read(prof)
        return kept["trace"]

    trace_lib.read = keep
    t0 = time.perf_counter()
    fresh = span_cost_us()
    layout = harness.Layout(ROOT)
    result = harness.run(layout, args.workload, args.seed, args.seconds,
                         True, device="cuda", t0=t0)
    tr = kept["trace"]
    placed = spans.place(tr)
    out = {"workload": args.workload, "seed": args.seed,
           "line": json.loads(result.line())}
    if placed is not None:
        roots = collections.Counter()
        for (_, s, e, _, _), sid, how in placed.ops:
            chain = {placed.spans[x].name for x in placed.chain(sid)}
            if chain & {"model.prefill", "serve.step"}:
                roots[how] += (e - s) / 1e9
        split, top = ffn_split(placed, ffn_gemm_share.KERNELS)
        out.update(placed_s=placed.shares(), in_roots_s=dict(roots),
                   decode_idle_s=placed.idle_by_span(),
                   ffn_split_s=split, ffn_kernels_s=top,
                   b4_in_steps=b4_in_steps(
                       tr, spans.program_spans(tr, "serve.step")),
                   busy_s=tr.busy_s, window_s=tr.window_s,
                   spans=len(spans.program_spans(tr)))
    out["span_us"] = {"fresh": fresh, "after": span_cost_us()}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
