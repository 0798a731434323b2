# Port of repro/launch/train.py.
"""Fault-tolerant training driver.

End-to-end: synthetic LM data -> prefetch to the device -> train step
(``Model.loss``, its backward, the optimizer's in-place update) ->
checkpoint every N steps (async, atomic) -> straggler monitor ->
supervisor that restarts from the latest checkpoint on (injected) node
failure.

The control flow is the reference's, quirks included: each
``train_round`` re-initialises the params (or copies ``params_init``)
and the optimizer state, restores the latest checkpoint if there is one
past step 0, and restarts the batch iterator from its seed, so a resumed
run replays the batches from the start of the stream at the restored
step; ``losses`` keeps the steps of every round, those before a failure
included. ``TrainReport.step_s`` (each step's seconds as the straggler
monitor sees them, ending in the host's read of the loss) is the port's
addition.

CLI (CPU, smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --steps 60 --batch 8 --seq 64 --ckpt-dir runs/ckpt_demo --fail-at 25 \\
      --device cpu
On the card: drop ``--device cpu``; ``--full`` trains the full config.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.prefetch import prefetch_to_device
from repro_torch.data.synthetic import lm_batches, lm_pool
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     StragglerMonitor,
                                                     supervise)
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizer import cosine_schedule, make_optimizer


@dataclasses.dataclass
class TrainReport:
    steps: int
    final_loss: float
    losses: List[float]
    restarts: int
    straggler_events: int
    ckpt_steps: List[int]
    step_s: List[float] = dataclasses.field(default_factory=list)


def make_train_step(model: Model, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient with respect to every leaf of
    ``params`` (which must require grad), then ``opt.update`` in place.
    ``metrics``: the loss's metrics, ``loss``, and the optimizer's
    ``grad_norm`` and ``lr``, as detached 0-d tensors."""
    def train_step(params, opt_state, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        params, opt_state, om = opt.update(tree_unflatten(params, grads),
                                           opt_state, params)
        out = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(out, loss=loss.detach(), **om)
    return train_step


def run_training(arch: str = "qwen1.5-4b", *, smoke: bool = True,
                 steps: int = 50, batch: int = 8, seq: int = 64,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
                 optimizer: str = "adamw", fail_at: Optional[List[int]] = None,
                 pool_size: int = 512, seed: int = 0,
                 log_every: int = 10, tokens: Optional[np.ndarray] = None,
                 params_init=None, lr: float = 3e-4,
                 warmup: int = 100, device="cuda") -> TrainReport:
    """Train ``arch`` (its smoke config, or with ``smoke=False`` its full
    one) on ``device``. ``params_init``: a port parameter tree every round
    starts from (copied), in place of ``Model.init(seed)``; ``tokens``
    (n, seq + 1) in place of the seeded ``lm_pool``."""
    device = torch.device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg)
    opt = make_optimizer(optimizer,
                         lr=cosine_schedule(lr, warmup, max(steps, 1000)))
    if tokens is None:
        tokens, _ = lm_pool(pool_size, seq + 1, cfg.vocab, seed=seed)
    train_step = make_train_step(model, opt)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    injector = FailureInjector(fail_at or [])
    monitor = StragglerMonitor()
    losses: List[float] = []
    step_s: List[float] = []

    def train_round(start_step: int) -> int:
        params = (model.init(seed, device) if params_init is None else
                  tree_map(lambda t: t.detach().to(device).clone(),
                           params_init))
        opt_state = opt.init(params)
        step = 0
        if mgr is not None and mgr.latest_step():
            (params, opt_state), step, _ = mgr.restore((params, opt_state))
        for t in tree_leaves(params):
            t.requires_grad_(True)
        data = lm_batches(tokens, batch, seed=seed)
        data = prefetch_to_device(data, size=2, device=device)
        for batch_ in data:
            if step >= steps:
                break
            t0 = time.perf_counter()
            injector.maybe_fail(step)
            params, opt_state, metrics = train_step(params, opt_state, batch_)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.observe(step, dt)
            step_s.append(dt)
            losses.append(loss)
            step += 1
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            if mgr is not None and step % ckpt_every == 0:
                mgr.save_async(step, (params, opt_state))
        if mgr is not None:
            mgr.wait()
            mgr.save(step, (params, opt_state))
        return step

    restarts = 0
    if mgr is not None:
        n_fail = len(fail_at or [])
        rep = supervise(train_round, total_steps=steps,
                        latest_step=mgr.latest_step,
                        max_restarts=n_fail + 2, monitor=monitor)
        restarts = rep.restarts
    else:
        train_round(0)

    return TrainReport(
        steps=steps, final_loss=losses[-1] if losses else float("nan"),
        losses=losses, restarts=restarts,
        straggler_events=len(monitor.events),
        ckpt_steps=mgr.all_steps() if mgr else [], step_s=step_s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default smoke)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rep = run_training(args.arch, smoke=not args.full, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       optimizer=args.optimizer, fail_at=args.fail_at,
                       device=args.device)
    print(f"done: {rep.steps} steps, final loss {rep.final_loss:.4f}, "
          f"restarts {rep.restarts}, stragglers {rep.straggler_events}, "
          f"ckpts {rep.ckpt_steps}")


if __name__ == "__main__":
    main()
