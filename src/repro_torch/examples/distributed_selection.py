# Port of examples/distributed_selection.py.
"""Pod-scale AL selection: score shards locally, merge globally.

Demonstrates the distributed selection layer (``core/selection.py``) on a
debug mesh of ``--world`` ranks (``launch.mesh``: one process each, a
``torch.distributed`` group): every rank computes the fused uncertainty
scores of its slice of the pool, then

  * budget-B uncertainty selection = local top-B + all_gather merge,
  * diversity selection = distributed greedy k-center,

with per-round communication independent of pool size. The pool (N
65,536 logits over C 512 classes, D 64 embeddings, budget 128) is the
reference example's, drawn from seed 0 by every rank, which keeps its
contiguous shard.

Run: PYTHONPATH=src python -m repro_torch.examples.distributed_selection \\
         --world 4 --device cpu
On the card: ``--device cuda``, the default (world 1 over NCCL; more
ranks share the one card over gloo, since NCCL refuses two ranks on one
device).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N, C, D, BUDGET = 65536, 512, 64, 128


def pool(seed: int = 0):
    """The example's pool: (logits (N, C), embeddings (N, D)), fp32."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(N, C)) * 2).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    return logits, emb


def select_on_rank(rank, world, group, device):
    """One rank's part: its shard's scores, the replicated top-k and
    k-center indices, timed; returns host copies for rank 0 to check."""
    from repro_torch.core.selection import (distributed_k_center,
                                            distributed_top_k,
                                            sharded_scores)
    n = N // world
    logits, emb = pool()
    lg = torch.from_numpy(logits[rank * n:(rank + 1) * n]).to(device)
    em = torch.from_numpy(emb[rank * n:(rank + 1) * n]).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    scores = sharded_scores(lg, "lc")                   # stays sharded
    idx_u = distributed_top_k(scores, BUDGET, group)    # replicated result
    sync()
    t_unc = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_d = distributed_k_center(em, BUDGET, group)
    sync()
    t_div = time.perf_counter() - t0
    return {"scores": scores.cpu(), "top_k": idx_u.cpu(),
            "k_center": idx_d.cpu(), "t_unc": t_unc, "t_div": t_div}


def main():
    from repro_torch.core.selection import stable_top_k
    from repro_torch.launch.mesh import run_debug_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    backend = ("nccl" if args.device.startswith("cuda") and args.world == 1
               else "gloo")
    out = run_debug_mesh(select_on_rank, args.world, backend=backend,
                         device=args.device)
    scores = torch.cat([o["scores"] for o in out])
    ref = stable_top_k(scores, BUDGET)[1]
    for o in out[1:]:
        assert torch.equal(o["top_k"], out[0]["top_k"])
        assert torch.equal(o["k_center"], out[0]["k_center"])
    match = len(set(out[0]["top_k"].tolist()) & set(ref.tolist()))
    print(f"pool={N} budget={BUDGET} ranks={args.world} ({backend}, "
          f"{args.device})")
    print(f"uncertainty top-k: {max(o['t_unc'] for o in out) * 1e3:.0f} "
          f"ms, {match}/{BUDGET} agree with the global reference")
    print(f"k-center greedy:   {max(o['t_div'] for o in out) * 1e3:.0f} "
          f"ms, {len(set(out[0]['k_center'].tolist()))} unique centers")


if __name__ == "__main__":
    main()
