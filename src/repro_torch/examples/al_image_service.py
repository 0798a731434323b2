# Port of examples/al_image_service.py.
"""One-round AL over an image pool — the paper's §4.2 experiment shape.

Compares a few zoo strategies + the PSHEA auto agent on a synthetic
CIFAR-like pool: select a budget, label, fine-tune the head, report eval
accuracy.

Run: PYTHONPATH=src python -m repro_torch.examples.al_image_service
(on the GPU; ``--device cpu`` runs it on the CPU).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.data.synthetic import image_pool
from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

STRATEGIES = ("random", "lc", "mc", "es", "coreset", "dbal")
POOL, EVAL_POOL, BUDGET, AUTO_BUDGET = 1200, 600, 120, 600
TARGET_ACCURACY = 0.97


def _server(device, backend, draws, X, Y, EX, EY):
    srv = ALServer(ALServiceConfig(batch_size=32, device=device),
                   backend=backend, draws=draws)
    keys = srv.push_data(list(X))
    key2y = dict(zip(keys, (int(y) for y in Y)))
    srv.attach_oracle(lambda ks: [key2y[k] for k in ks], EX, EY)
    return srv, key2y


def run(device="cuda", backend=None, draws=None, log: bool = True) -> dict:
    """Each fixed strategy on a fresh server (select BUDGET, label, fit
    the head, evaluate), then PSHEA at AUTO_BUDGET. ``backend``
    and ``draws`` go to every ``ALServer`` (None: built from the config,
    and the production draws). Returns {"results": {strategy: {"keys",
    "accuracy", "seconds"}}, "auto": PSHEA's {"strategy", "accuracy",
    "stop_reason", "eliminated", "candidates"}, "best_fixed", "device"}."""
    X, Y = image_pool(POOL, seed=0)
    EX, EY = image_pool(EVAL_POOL, seed=1)

    results = {}
    for strategy in STRATEGIES:
        srv, key2y = _server(device, backend, draws, X, Y, EX, EY)
        try:
            t0 = time.perf_counter()
            res = srv.query(budget=BUDGET, strategy=strategy)
            srv.label(res["keys"], [key2y[k] for k in res["keys"]])
            acc = srv.train_and_eval()
            dt = time.perf_counter() - t0
        finally:
            srv.close()
        results[strategy] = {"keys": list(res["keys"]), "accuracy": acc,
                             "seconds": dt}
        if log:
            print(f"{strategy:10s} acc={acc:.3f}  select+train={dt:.2f}s")

    # PSHEA auto-selection (paper Alg. 1)
    srv, _ = _server(device, backend, draws, X, Y, EX, EY)
    try:
        auto = srv.query(budget=AUTO_BUDGET, strategy="auto",
                         target_accuracy=TARGET_ACCURACY)
        dev = srv.stats()["device"]
    finally:
        srv.close()
    best_fixed = max(results, key=lambda s: results[s]["accuracy"])
    if log:
        print(f"\nPSHEA picked {auto['strategy']!r} "
              f"(acc {auto['accuracy']:.3f}, stop: {auto['stop_reason']}); "
              f"eliminated order: {auto['eliminated']}")
        print(f"best fixed strategy was {best_fixed!r} "
              f"(acc {results[best_fixed]['accuracy']:.3f})")
    return {"results": results,
            "auto": {"strategy": auto["strategy"],
                     "accuracy": auto["accuracy"],
                     "stop_reason": auto["stop_reason"],
                     "eliminated": list(auto["eliminated"]),
                     "candidates": list(auto["history"])},
            "best_fixed": best_fixed, "device": dev}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main():
    run(device=parser().parse_args().device)


if __name__ == "__main__":
    main()
