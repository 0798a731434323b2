"""The harness: finds a cell's configuration, traffic, metrics and limits
by the names in ``BENCHMARK.json``, builds the system under test, runs the
measured window, checks what the window produced against the plain
reference, and assembles the result line.

The system under test is the port's serving path, driven as
``launch/serve.py``'s ``run_serving`` drives it, without its per-call
set-up: ``Model(cfg)`` with ``attention_impl="pallas"`` (the kernels on
the card), weights the benchmark makes on the device from the seed in
the layout ``Model.param_decls()`` declares, and one cache from
``Model.init_cache`` at the batch and ``prompt_len + scored_steps``
positions. Each batch of the window is two calls: ``Model.prefill(params,
{"tokens": prompts}, cache)``, then ``serve_steps(model, params, cache,
logits, scored_steps, feed=answers)``, which scores every step with the
uncertainty kernel. The loop is closed with one batch in flight; it
starts batches until ``seconds`` have passed and ends with the last
one's completion.

The check: one batch of the window, drawn from the seed (reservoir
sampling, so any batch is as likely), keeps its prefill logits, every
step's logits and scores, for a MoE the routes its router chose, and one
layer's attention calls, as far as the cell's kernel numbers need them
(``tape.AttentionTape``); once the window has closed and the peak memory
is read, the cache is freed and the architecture's plain reference runs
over the batch's tokens in float32 (``compare.readings``), and plain
attention over the kernels' own inputs (``compare.kernels``). Every
batch's scores must also be finite.

What is particular to an architecture comes from its module,
``bench/archs/<model_type>.py``, found by the configuration's
``model_type`` (``Layout.arch``; the contract is in ``bench/archs``'s
docstring): the port's configuration (``port_config``), the plain
reference (``REFERENCE``, a module under ``bench/reference/``), the work
count the metric readers take (``batch_work``), the weights that carry
the cell's logit spread (``SPREAD_LEAVES``) and the kernel numbers its
path can give (``KERNEL_CHECKS``). So a new architecture is new files
and entries, and no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import compare, trace as trace_lib, weights
from bench.tape import AttentionTape
from bench.traffic import Documents, ScoreSweep, seed_entropy

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Arch:
    """What one ``model_type`` brings (``bench/archs/<model_type>.py``):
    ``reference`` is the module its ``REFERENCE`` names."""
    port_config: Callable[[dict], object]
    reference: object
    batch_work: Callable[[dict, ScoreSweep], object]
    spread_leaves: Tuple[str, ...]
    kernel_checks: Tuple[str, ...]


class Layout:
    """The benchmark's files under ``root`` (a checkout, or a copy of its
    layout): ``BENCHMARK.json`` and ``bench/{configs,traffic,metrics,
    limits,archs,reference}``."""

    def __init__(self, root):
        self.root = Path(root)
        self.bench = self.root / "bench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._archs: Dict[str, Arch] = {}

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[c['name'] for c in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for conf in self.spec["configs"]:
            if conf["name"] == name:
                return json.loads((self.root / conf["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def _check(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json")
                          .read_text())

    def limits(self, cell: str) -> dict:
        return self._check(cell)["limits"]

    def qk_logit_std(self, cell: str) -> float:
        """The spread of the seeded weights' attention logits that the
        cell's limits were set with (``weights.make``; 1 where the file
        names none)."""
        return float(self._check(cell).get("weights", {})
                     .get("qk_logit_std", 1.0))

    def _module(self, kind: str, name: str):
        path = self.bench / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no {kind} module {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod      # as an import would (dataclasses)
        spec.loader.exec_module(mod)
        return mod

    def arch(self, conf: dict) -> Arch:
        """The architecture of ``conf``, by its ``model_type``, loaded once
        a layout."""
        name = conf["model_type"]
        if name not in self._archs:
            mod = self._module("archs", name)
            self._archs[name] = Arch(
                port_config=mod.port_config,
                reference=self._module("reference", mod.REFERENCE),
                batch_work=mod.batch_work,
                spread_leaves=tuple(mod.SPREAD_LEAVES),
                kernel_checks=tuple(mod.KERNEL_CHECKS))
        return self._archs[name]

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's metrics for the run's mode: end-to-end with tracing
        off, per-layer with it on; each with ``read``, its reader."""
        out = []
        for m in self.spec["per_layer" if trace else "end_to_end"]:
            if cell not in m.get("workloads", [cell]):
                continue
            out.append(dict(m, read=self._module("metrics", m["name"]).read))
        return out


@dataclasses.dataclass
class BatchTimes:
    start: float
    end: float
    prefill_end: Optional[float] = None    # with --trace 1 only
    decode_end: Optional[float] = None


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    conf: dict
    traffic: ScoreSweep
    work: object                      # the arch's batch_work of one batch
    setup_s: float
    window_s: float
    batches: List[BatchTimes]
    memory_peak_bytes: Optional[int]
    trace: Optional[trace_lib.Trace] = None


class _Recording:
    """Wraps the model that ``serve_steps`` drives so that, in a batch the
    check may read (``on``), each step's logits stay reachable until the
    batch ends."""

    def __init__(self, model):
        self.model = model
        self.on = True
        self.step_logits: List[torch.Tensor] = []

    def decode_step(self, params, cache, token):
        logits, cache = self.model.decode_step(params, cache, token)
        if self.on:
            self.step_logits.append(logits)
        return logits, cache


def _compact_tape():
    """The port's ``RouteTape``, recording a compact copy of each call's
    routes (int16 experts and slots) instead of the routing's own
    tensors, which are views that would keep its whole sort alive."""
    from repro_torch.models.layers.moe import Routes, RouteTape

    class CompactTape(RouteTape):
        def route(self, own):
            self.recorded.append(Routes(own.topi.to(torch.int16),
                                        own.slot.to(torch.int16)))
            return own

    return CompactTape()


class Sweep:
    """The system under test, set up for one cell and seed."""

    def __init__(self, layout: Layout, cell: dict, seed: int, device):
        from repro_torch.launch import serve
        from repro_torch.models.transformer import Model
        self.serve_steps = serve.serve_steps
        self.device = torch.device(device)
        self.conf = layout.config(cell["config"])
        self.arch = layout.arch(self.conf)
        self.traffic = ScoreSweep.from_file(layout.traffic(cell["traffic"]))
        cfg = self.arch.port_config(self.conf)
        # the port's own seam: in a batch the check may read, it records
        # each MoE call's routes, which the reference then follows
        if cfg.moe is not None and max(cfg.moe.n_routed,
                                       cfg.moe.group_size) >= 2 ** 15:
            raise ValueError("the route tape records int16 experts, slots")
        self.route_tape = _compact_tape() if cfg.moe is not None else None
        self.model = Model(cfg, routes=self.route_tape)
        self.recording = _Recording(self.model)
        self.docs = Documents(self.traffic, self.conf["vocab_size"], seed)
        self.params = weights.make(self.model.param_decls(),
                                   self.conf["vocab_size"], seed, self.device,
                                   layout.qk_logit_std(cell["name"]),
                                   self.arch.spread_leaves)
        t = self.traffic
        self.cache = self.model.init_cache(t.batch, t.positions, self.device)
        limits = layout.limits(cell["name"])
        self.tape = AttentionTape(
            self.conf["num_hidden_layers"], t.batch, t.prompt_len, seed,
            self.device, [n for n in self.arch.kernel_checks if n in limits])
        self.tape.install()
        self.attn = None

    def inputs(self, i: int, stream: int = 1):
        """Batch ``i``'s tokens (host) and its prompts and fed answers on
        the device."""
        toks = self.docs.batch(i, stream)
        prompts, fed = Documents.split(toks, self.traffic.scored_steps)
        return (toks, torch.from_numpy(prompts).to(self.device),
                torch.from_numpy(fed).to(self.device))

    def run_batch(self, prompts, fed, sync: Callable[[], None],
                  span=None, times: Optional[BatchTimes] = None,
                  record: bool = True):
        """One batch: prefill, then the scored steps. ``span``: a context
        factory around each part (``--trace 1``), whose parts then end
        synchronised. ``record``: keep the step logits, the MoE routes and
        one layer's attention (``attn``): a batch the check may read.
        Returns (prefill logits, step logits, scores)."""
        self.recording.step_logits = []
        self.recording.on = record
        if self.route_tape is not None:
            self.route_tape.recorded = []
            self.model.routes = self.route_tape if record else None
        self.tape.start(record)
        if span is None:
            self.cache, logits = self.model.prefill(
                self.params, {"tokens": prompts}, self.cache)
            scores, _ = self.serve_steps(self.recording, self.params,
                                         self.cache, logits,
                                         self.traffic.scored_steps, feed=fed)
            self.attn = self.tape.take()
            return logits, self.recording.step_logits, scores
        with span("bench.prefill"):
            self.cache, logits = self.model.prefill(
                self.params, {"tokens": prompts}, self.cache)
            sync()
        times.prefill_end = time.perf_counter()
        with span("bench.decode"):
            scores, _ = self.serve_steps(self.recording, self.params,
                                         self.cache, logits,
                                         self.traffic.scored_steps, feed=fed)
            sync()
        times.decode_end = time.perf_counter()
        self.attn = self.tape.take()
        return logits, self.recording.step_logits, scores

    def routes(self):
        """The last batch's MoE routes, (experts, slots) a call, or None."""
        if self.route_tape is None:
            return None
        return [(r.topi.long(), r.slot.long())
                for r in self.route_tape.recorded]

    def free(self):
        """Drop the cache (the reference runs beside the weights alone)."""
        self.cache = None
        self.recording.step_logits = []

    def close(self):
        """Take the attention tape off the port's kernel entry points."""
        self.tape.remove()


@dataclasses.dataclass
class Kept:
    """The sampled batch: its tokens and what the timed path produced."""
    tokens: np.ndarray
    prefill_logits: torch.Tensor
    step_logits: List[torch.Tensor]
    scores: torch.Tensor
    routes: Optional[list]
    attn: object                      # tape.Record


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None
    batches: List[BatchTimes] = dataclasses.field(default_factory=list)

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return json.dumps(out)


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def run(layout: Layout, workload: str, seed: int, seconds: float,
        trace: bool, device="cuda", t0: Optional[float] = None,
        break_with=None) -> Result:
    """One run of ``workload``. ``t0``: the process's start on
    ``time.perf_counter``'s clock (set-up counts from it). ``break_with``:
    a function handed the ``Sweep`` after set-up, which may break the
    timed path (the fault tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = layout.cell(workload)
    metrics = layout.metrics(workload, trace)
    limits = layout.limits(workload)
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        from repro_torch.kernels import build
        build.build_all(("flash_attention_bf16", "decode_attention",
                         "uncertainty_stats"))
        torch.cuda.reset_peak_memory_stats(device)
    sweep = Sweep(layout, cell, seed, device)
    try:
        return _measure(sweep, cell, metrics, limits, seed, seconds, trace,
                        device, sync, t0, break_with)
    finally:
        sweep.close()


def _measure(sweep: Sweep, cell: dict, metrics, limits, seed: int,
             seconds: float, trace: bool, device, sync, t0: float,
             break_with) -> Result:
    cuda = device.type == "cuda"
    t = sweep.traffic
    # warm-up: one whole batch of the cell's shapes, drawn apart from the
    # window's batches
    _, prompts, fed = sweep.inputs(0, stream=3)
    sweep.run_batch(prompts, fed, sync)
    sync()
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts):       # the profiler's own start-up
            sync()
        profiler = profile(activities=acts)
    if break_with is not None:
        break_with(sweep)

    picker = np.random.default_rng([seed_entropy(seed), 2])
    kept: Optional[Kept] = None
    bad_docs = torch.zeros((), dtype=torch.long, device=device)
    times: List[BatchTimes] = []
    span = torch.profiler.record_function if trace else None
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    i = 0
    while True:
        toks, prompts, fed = sweep.inputs(i)
        bt = BatchTimes(time.perf_counter(), 0.0)
        if profiler is not None and i == 0:
            profiler.start()
        keep = picker.random() * (i + 1) < 1.0    # reservoir of one
        if span is not None:
            with span("bench.batch"):
                logits, steps, scores = sweep.run_batch(
                    prompts, fed, sync, span, bt, record=keep)
        else:
            logits, steps, scores = sweep.run_batch(prompts, fed, sync,
                                                    record=keep)
        ok = torch.isfinite(scores).all(0).all(0)           # (B,)
        bad_docs += (~ok).sum()
        if keep:
            kept = Kept(toks, logits, list(steps), scores, sweep.routes(),
                        sweep.attn)
        sync()
        bt.end = time.perf_counter()
        if profiler is not None and i + 1 == t.trace_batches:
            profiler.stop()
        times.append(bt)
        i += 1
        if bt.end - start >= seconds:
            break
    if profiler is not None and i < t.trace_batches:
        profiler.stop()
    window_s = times[-1].end - start
    failed = int(bad_docs)
    dev = device_info(device, cell["chips"])
    peak = dev["memory_peak_bytes"] if cuda else None

    trace_obj = trace_lib.read(profiler) if profiler is not None else None
    ctx = Context(sweep.conf, t, sweep.arch.batch_work(sweep.conf, t),
                  setup_s, window_s, times, peak, trace_obj)
    values = {}
    for m in metrics:
        v = m["read"](ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    breakdown = None
    if trace_obj is not None and cuda and trace_obj.ops:
        dev["busy_s"] = trace_obj.busy_s
        dev["window_s"] = trace_obj.window_s
        breakdown = trace_obj.breakdown()

    sweep.free()
    del logits, steps, scores
    if cuda:
        torch.cuda.empty_cache()
    reference = sweep.arch.reference
    routing = (None if kept.routes is None
               else reference.Routing(forced=kept.routes))
    ref = reference.forward(
        sweep.conf, sweep.params,
        torch.from_numpy(kept.tokens).to(device), t.prompt_len,
        routing=routing)
    port_logits = torch.stack([kept.prefill_logits] + kept.step_logits, 1)
    numbers = compare.readings(port_logits, kept.scores, ref, routing)
    numbers.update(compare.kernels(kept.attn))
    checks = compare.judge(numbers, limits)
    correct = failed == 0 and compare.passed(checks)
    return Result(correct=correct, attempted=i * t.batch, failed=failed,
                  metrics=values, device=dev, checks=checks,
                  breakdown=breakdown, batches=times)
