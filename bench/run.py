"""Run one cell of the benchmark on the GPU this process is started on.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error. Exits with another code than 0, and prints
no result, where CUDA is not available or has fewer devices than the cell
asks for, and where the process has loaded JAX, flax or the JAX package.
Caches of compiled code stay under ``build/`` inside the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv"),
                 ("REPRO_TORCH_AUTOTUNE_CACHE_DIR", "autotune")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from bench import harness
    layout = harness.Layout(ROOT)
    cell = layout.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the GPU only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = harness.run(layout, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded {bad}: the port and the benchmark may not "
              f"import JAX, flax or the JAX package", file=sys.stderr)
        return 3
    for b in result.batches:
        parts = [f"batch {b.end - b.start!r} s"]
        if b.decode_end is not None:
            parts += [f"prefill {b.prefill_end - b.start!r} s",
                      f"decode {b.decode_end - b.prefill_end!r} s"]
        print(", ".join(parts), file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(result.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
