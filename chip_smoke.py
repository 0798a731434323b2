"""Chip smoke test for repro_torch: the port's main path on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. env      card name and power limit, torch/CUDA versions, and the time
            to build the CUDA kernels from ``src/repro_torch`` (one nvcc
            per source, started together).
2. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes (values within the stated tolerance,
            indices exactly equal on planted ties and on separated rows),
            with its median time from CUDA events, its bound, the plain
            version's time and a PyTorch library call's time.
3. server   the ALaaS Fig. 2 loop over TCP: an ALServer with resnet18 on
            the GPU, a 50,000-image 32x32x3 pool pushed by ALClient, a
            10,000-image eval set, lc/mc/rc/es/kcg/dbal queries of 1,000,
            label + train_eval, a warm-started coreset query, and one
            PSHEA ("auto") run of budget 2,000. Kernel launch counts are
            zeroed just before this phase and read just after it; each
            kernel must have launched.
4. agree    k-center greedy (budget 1,000) over the server's own features
            through the kernel and through the plain version; prints the
            rounds before the first divergence.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when there is no CUDA device or the package is not beside this file.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
POOL, EVAL, HW, BUDGET, AUTO_BUDGET = 50_000, 10_000, 32, 1_000, 2_000
D = 512                                  # resnet18 feat_dim
HBM_BYTES_S = 3.35e12                    # H100 SXM HBM3
FP32_FLOPS_S = 67e12                     # H100 SXM fp32, outside tensor cores
ATOL = 1e-5                              # fp32 values, at O(1) sq-distances
REPS = 25


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=REPS) -> float:
    fn()                                         # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_S, flops / FP32_FLOPS_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# --------------------------------------------------------------- kernels --
def check_greedy(ops, dev, rng):
    """greedy_round at N = 50,000 (and ragged 49,999), d = 512, R in
    {1, 8, r_block}, weighted and unweighted, carried-in -1 rows and a
    planted exact tie (two identical far rows: the lower index must win;
    they sit 256 rows apart, at the same offset in any power-of-two tile,
    so the plain version's matrix product treats them alike too)."""
    from repro_torch.kernels.pairwise import autotune
    r_block = autotune.model_blocks(POOL, D).r_block
    worst, cases = 0.0, 0
    for n in (POOL, POOL - 1):
        x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
            np.float32)).to(dev)
        tie = (1234, 1234 + 256 * ((n - 1235) // 512))
        x[tie[1]] = x[tie[0]] = x[tie[0]] * 3.0
        others = np.setdiff1d(np.arange(n), tie)
        for r in (1, 8, r_block):
            for weighted in (False, True):
                mind = torch.full((n,), 3.4e38, device=dev)
                mind[torch.from_numpy(rng.choice(others, 500, replace=False))
                     .to(dev)] = -1.0
                sel = torch.from_numpy(rng.choice(
                    others, r, replace=False).astype(np.int32)).to(dev)
                w = None
                if weighted:
                    w = torch.rand(n, device=dev)
                    w[tie[0]] = w[tie[1]] = 1.0
                args = (x, mind, x[sel.long()], sel, w)
                kn, ki, ks = ops.greedy_round(*args)
                pn, pi, ps = ops.greedy_round(*args, impl="ref")
                torch.cuda.synchronize()
                err = float((kn - pn).abs().max())
                assert err <= ATOL, (n, r, weighted, err)
                assert int(ki) == int(pi) == tie[0], (n, r, weighted,
                                                      int(ki), int(pi))
                assert abs(float(ks) - float(ps)) <= ATOL * max(
                    1.0, abs(float(ps)))
                worst, cases = max(worst, err), cases + 1
    return worst, cases, r_block


def time_greedy(ops, dev, rng):
    """The k-center round the main path runs most: R = 1, unweighted."""
    x = torch.from_numpy((rng.standard_normal((POOL, D)) * 0.05).astype(
        np.float32)).to(dev)
    mind = torch.full((POOL,), 3.4e38, device=dev)
    c, sel = x[7:8], torch.tensor([7], dtype=torch.int32, device=dev)
    ms = median_ms(lambda: ops.greedy_round(x, mind, c, sel))
    plain = median_ms(lambda: ops.greedy_round(x, mind, c, sel, impl="ref"))
    nb = -(-POOL // 64)
    nbytes = 4 * (POOL * D + D + 1 + 2 * POOL + 2 * nb)
    return ms, plain, bound(nbytes, 3.0 * POOL * D)


def check_argmin(ops, dev, rng):
    """pairwise_min_argmin at N = 10,000 x M = 1,000 x d = 512 (DBAL's
    Lloyd step at budget 1,000), plus ragged N and M, with planted exact
    ties (center 3 duplicated at 259 and 515: the same offset in any
    power-of-two tile). Indices must match exactly on tie rows and
    on rows whose best and second-best distances differ by > 10 * ATOL;
    on the other rows the kernel's pick must be within ATOL of the min."""
    worst, compared = 0.0, 0
    for n, m in ((10 * BUDGET, BUDGET), (10 * BUDGET - 3, BUDGET - 5)):
        x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
            np.float32)).to(dev)
        c = torch.from_numpy((rng.standard_normal((m, D)) * 0.05).astype(
            np.float32)).to(dev)
        c[259] = c[515] = c[3]                      # three-way tie at 3
        x[:100] = c[3] + 1e-3
        km, ka = ops.pairwise_min_and_argmin(x, c)
        pm, pa = ops.pairwise_min_and_argmin(x, c, impl="ref")
        torch.cuda.synchronize()
        err = float((km - pm).abs().max())
        assert err <= ATOL, (n, m, err)
        assert bool((ka[:100] == 3).all()) and bool((pa[:100] == 3).all())
        d = ops.pairwise_sq_dists(x, c)
        top2 = torch.topk(d, 2, dim=1, largest=False).values
        sep = (top2[:, 1] - top2[:, 0]) > 10 * ATOL
        sep[:100] = True
        assert torch.equal(ka[sep], pa[sep]), (n, m)
        picked = torch.gather(d, 1, ka.long()[:, None])[:, 0]
        assert float((picked - pm).abs().max()) <= ATOL
        worst, compared = max(worst, err), compared + int(sep.sum())
    return worst, compared


def time_argmin(ops, dev, rng):
    n, m = 10 * BUDGET, BUDGET
    x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
        np.float32)).to(dev)
    c = torch.from_numpy((rng.standard_normal((m, D)) * 0.05).astype(
        np.float32)).to(dev)
    ms = median_ms(lambda: ops.pairwise_min_and_argmin(x, c))
    plain = median_ms(lambda: ops.pairwise_min_and_argmin(x, c, impl="ref"))
    library = median_ms(lambda: torch.cdist(x, c).min(1))
    nbytes = 4 * ((n + m) * D + 2 * n)
    return ms, plain, library, bound(nbytes, 2.0 * n * m * D + 2.0 * (n + m) * D)


# ---------------------------------------------------------------- server --
YML = f"""
name: "CIFAR10_RESNET18"
active_learning:
  strategy:
    type: "lc"
  model:
    name: "resnet18"
    batch_size: 256
  device: cuda
  target_accuracy: 0.99
al_worker:
  protocol: "tcp"
  host: "127.0.0.1"
  port: 0
  replicas: 1
"""


def run_server(ops):
    from repro_torch.data.synthetic import image_pool
    from repro_torch.service.client import ALClient, serve_tcp
    from repro_torch.service.config import ALServiceConfig
    from repro_torch.service.server import ALServer

    cfg = ALServiceConfig.from_yaml(YML)
    srv = ALServer(cfg)
    assert srv.device.type == "cuda" and cfg.replicas == 1
    rpc = serve_tcp(srv, cfg.host, cfg.port)
    cli = ALClient(url=f"{cfg.host}:{rpc.port}")
    wall = {}
    try:
        xs, ys = image_pool(POOL, hw=HW, seed=3)
        ex, ey = image_pool(EVAL, hw=HW, seed=4)
        ops.reset_launches()                 # the main path starts here
        t = time.perf_counter()
        keys = []
        for s in range(0, POOL, 2_500):
            keys += cli.push_data(list(xs[s:s + 2_500]))
        wall["push_pool"] = time.perf_counter() - t
        key2y = dict(zip(keys, (int(y) for y in ys)))
        t = time.perf_counter()
        srv.attach_oracle(lambda ks: [key2y[k] for k in ks], ex, ey)
        wall["attach_oracle_eval"] = time.perf_counter() - t
        picks = {}
        for strategy in ("lc", "mc", "rc", "es", "kcg", "dbal"):
            t = time.perf_counter()
            res = cli.query(budget=BUDGET, strategy=strategy, rng_seed=1)
            wall[f"query_{strategy}"] = time.perf_counter() - t
            assert len(set(res["keys"])) == BUDGET, strategy
            picks[strategy] = res["keys"]
        t = time.perf_counter()
        cli.label(picks["lc"], [key2y[k] for k in picks["lc"]])
        wall["label"] = time.perf_counter() - t
        t = time.perf_counter()
        acc = cli.train_eval()
        wall["train_eval"] = time.perf_counter() - t
        t = time.perf_counter()
        res = cli.query(budget=BUDGET, strategy="coreset", rng_seed=2)
        wall["query_coreset_warm"] = time.perf_counter() - t
        assert len(set(res["keys"])) == BUDGET
        assert not set(res["keys"]) & set(picks["lc"])
        t = time.perf_counter()
        auto = cli.query(budget=AUTO_BUDGET, strategy="auto")
        wall["query_auto"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)        # ... and ends here
        stats = cli.stats()
    finally:
        cli.close()
        rpc.stop()
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    assert auto["budget_spent"] > 0 and auto["rounds"] >= 1
    assert stats["pool"] == POOL and stats["labeled"] == BUDGET
    for name, count in launches.items():
        assert count > 0, f"{name} never launched on the main path"
    feats = srv.session()._artifact_snapshot()[0]
    assert feats.shape == (POOL, D) and np.isfinite(feats).all()
    log("server", wall_s=wall, launches=launches,
        embed_rows=srv.embed_rows, accuracy=acc,
        auto={k: auto[k] for k in ("strategy", "accuracy", "stop_reason",
                                   "rounds", "eliminated", "budget_spent")})
    return launches, feats


def agreement(feats, dev):
    """k-center greedy, budget 1,000, over the server's real features,
    through the kernel and through the plain version, same seed."""
    from repro_torch.common import rng as rnglib
    from repro_torch.core.strategies.diversity import k_center_greedy
    x = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
    k = rnglib.key(0)
    t = time.perf_counter()
    a = k_center_greedy(k, BUDGET, x).cpu().numpy()
    t_kernel = time.perf_counter() - t
    t = time.perf_counter()
    b = k_center_greedy(k, BUDGET, x, impl="ref").cpu().numpy()
    t_plain = time.perf_counter() - t
    diff = np.nonzero(a != b)[0]
    first = int(diff[0]) if diff.size else BUDGET
    assert len(set(a.tolist())) == BUDGET
    log("agree", rounds_before_divergence=first, budget=BUDGET,
        same_set=bool(set(a.tolist()) == set(b.tolist())),
        kernel_s=t_kernel, plain_s=t_plain)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.pairwise import ops

    dev = torch.device("cuda")
    smi = nvidia_smi()
    t = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t
    log("env", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        kernel_build_s=build_s)

    rng = np.random.default_rng(0)
    g_err, g_cases, r_block = check_greedy(ops, dev, rng)
    g_ms, g_plain, (g_bound, g_by) = time_greedy(ops, dev, rng)
    a_err, a_rows = check_argmin(ops, dev, rng)
    a_ms, a_plain, a_lib, (a_bound, a_by) = time_argmin(ops, dev, rng)
    log("kernels", tolerance_abs=ATOL,
        greedy_round={"cases": g_cases, "max_abs_err": g_err,
                      "r_block": r_block, "timed_shape": [POOL, D, 1],
                      "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
                      "bound_by": g_by},
        pairwise_min_argmin={"max_abs_err": a_err, "index_rows": a_rows,
                             "timed_shape": [10 * BUDGET, BUDGET, D],
                             "ms": a_ms, "plain_ms": a_plain,
                             "bound_ms": a_bound, "bound_by": a_by,
                             "library_ms": a_lib})

    launches, feats = run_server(ops)
    agreement(feats, dev)

    src = "src/repro_torch/kernels/pairwise/csrc/"
    kernels = [
        {"name": "greedy_round", "route": "cuda",
         "source": src + "greedy_round.cu",
         "replaces": "src/repro/kernels/pairwise/kernel.py:159",
         "launches": launches["greedy_round"], "max_abs_err": g_err,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": None},
        {"name": "pairwise_min_argmin", "route": "cuda",
         "source": src + "pairwise_min_argmin.cu",
         "replaces": "src/repro/kernels/pairwise/kernel.py:87",
         "launches": launches["pairwise_min_argmin"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": a_lib},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
