# Port of examples/al_train_loop.py.
"""End-to-end driver: multi-round active learning over an LM token pool,
with real fine-tuning between rounds (the 'data-centric LLM' workflow).

Each round: score the unlabeled pool with the current model (softmax of
the last-token logits, and pooled embeddings where the strategy needs
them), select with a zoo strategy, 'label' the selected sequences (the
synthetic oracle is their true continuation), fine-tune the LM on the
labeled set through ``make_optimizer("adamw")``, evaluate held-out loss.
Compares entropy sampling (``es``) against random selection. At the end,
the loss on the labeled rows under the weights before any fine-tuning and
under the final ones says how far the fine-tuning moved the model (the
held-out rows come from a pool of another seed, whose token tables at a
large vocabulary share few tokens with the training pool's).

Run: PYTHONPATH=src python -m repro_torch.examples.al_train_loop \\
         --device cpu                      (qwen1.5-4b's smoke config)
On the card: ``--full --depth 4`` (full width, 4 layers); ``--device``
defaults to cuda.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.common.rng import key
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.strategies.zoo import get_strategy
from repro_torch.data.synthetic import lm_pool
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizer import make_optimizer

ARCH = "qwen1.5-4b"
POOL, SEQ, ROUNDS, BUDGET, FT_STEPS = 256, 48, 3, 32, 30


def config(full: bool = False, depth=None):
    """qwen1.5-4b's smoke config, or its full one; ``depth`` cuts the
    layers (every width kept)."""
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(strategy_name: str, cfg, device="cuda", log: bool = True) -> dict:
    """ROUNDS rounds of select + fine-tune with one strategy, from the
    weights of seed 0. Returns {"eval0": the held-out loss before any
    fine-tuning, "evals": after each round, "round_s": each round's wall
    seconds, "labeled0" and "labeled": the loss on the rows labeled by the
    end under the weights before any fine-tuning and under the final
    ones}."""
    device = torch.device(device)
    model = Model(cfg)
    opt = make_optimizer("adamw")
    train_step = make_train_step(model, opt)
    tokens, _ = lm_pool(POOL, SEQ + 1, cfg.vocab, seed=0)
    eval_tokens, _ = lm_pool(64, SEQ + 1, cfg.vocab, seed=99)
    tok = torch.from_numpy(tokens).to(device)
    eval_batch = {"tokens": torch.from_numpy(eval_tokens[:, :-1]).to(device),
                  "labels": torch.from_numpy(eval_tokens[:, 1:]).to(device)}
    params = model.init(0, device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt_state = opt.init(params)
    params0 = tree_map(lambda t: t.detach().clone(), params)
    with torch.no_grad():
        eval0 = float(model.loss(params, eval_batch)[0])
    strat = get_strategy(strategy_name)
    labeled = np.zeros(POOL, bool)
    evals, round_s = [], []
    for rnd in range(ROUNDS):
        _sync(device)
        t0 = time.perf_counter()
        pool_idx = np.where(~labeled)[0]
        pool_batch = {"tokens": tok[torch.from_numpy(pool_idx).to(device),
                                    :SEQ]}
        probs = torch.softmax(model.last_logits(params, pool_batch), dim=-1)
        emb = (model.embed_pool(params, pool_batch)
               if "embeddings" in strat.needs else None)
        sel = strat.select(key(rnd), min(BUDGET, len(pool_idx)),
                           probs=probs if "probs" in strat.needs else None,
                           embeddings=emb, labeled_embeddings=None)
        labeled[pool_idx[sel.cpu().numpy()]] = True
        lab_idx = np.where(labeled)[0]
        for step in range(FT_STEPS):
            take = np.random.default_rng(rnd * 1000 + step).choice(
                lab_idx, size=min(8, len(lab_idx)), replace=False)
            rows = tok[torch.from_numpy(take).to(device)]
            batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
            params, opt_state, _ = train_step(params, opt_state, batch)
        with torch.no_grad():
            ev = float(model.loss(params, eval_batch)[0])
        _sync(device)
        round_s.append(time.perf_counter() - t0)
        evals.append(ev)
        if log:
            print(f"  [{strategy_name}] round {rnd}: labeled "
                  f"{labeled.sum():3d}/{POOL}, eval loss {ev:.4f}, "
                  f"{round_s[-1]:.2f} s", flush=True)
    rows = tok[torch.from_numpy(np.where(labeled)[0]).to(device)]
    lab_batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    with torch.no_grad():
        lab0 = float(model.loss(params0, lab_batch)[0])
        lab = float(model.loss(params, lab_batch)[0])
    if log:
        print(f"  [{strategy_name}] labeled rows' loss {lab0:.4f} -> "
              f"{lab:.4f}", flush=True)
    return {"eval0": eval0, "evals": evals, "round_s": round_s,
            "labeled0": lab0, "labeled": lab}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="qwen1.5-4b's full config (default smoke)")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut the config to this many layers")
    args = ap.parse_args()
    cfg = config(args.full, args.depth)
    t0 = time.perf_counter()
    print("strategy: entropy sampling (es)")
    es = run("es", cfg, args.device)["evals"]
    print("strategy: random")
    rnd = run("random", cfg, args.device)["evals"]
    print(f"\nfinal eval loss  es={es[-1]:.4f}  random={rnd[-1]:.4f} "
          f" ({time.perf_counter()-t0:.0f}s total)")


if __name__ == "__main__":
    main()
