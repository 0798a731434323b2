"""The port's span recorder (``common/spans.py``) and the spans at the
scoring path's layer boundaries.

Off (no profiler recording), ``span`` hands back one shared object: no
record, no ``record_function``, no clock read, no allocation, and well
under 1 us a span. Under ``torch.profiler`` on the smoke widths of the
dense stack (internlm2-20b) and the MoE stack (deepseek-moe-16b), a
prefill and three decode steps give the exact tree: ``model.prefill``
and each ``serve.step`` at the root, a ``layer.mixer`` and a
``layer.ffn`` under it for each layer, and ``moe.route``,
``moe.dispatch``, ``moe.combine`` under each MoE layer's ``layer.ffn``.
A record lies between the profiler's own events around it and inside
it, the median edge within 50 us (one clock); a span adds no event to
the profiler's trace; two threads keep separate stacks; logits and
scores are bitwise those of a run with the recorder off. On the card, ``serve_steps`` with
the recorder on runs under ``torch.cuda.set_sync_debug_mode("error")``:
the spans add no host sync.
"""
import dataclasses
import itertools
import statistics
import threading
import time
import tracemalloc
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.common import spans
from repro_torch.launch.serve import serve_steps
from repro_torch.models import transformer
from repro_torch.models.transformer import Model

ARCHS = ("internlm2-20b", "deepseek-moe-16b")
MOE = ("moe.route", "moe.dispatch", "moe.combine")
STEPS = 3


def _cfg(arch, impl="chunked"):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               attention_impl=impl)


def _serve(model, params, device, recording: bool):
    """A prefill of 2 x 8 tokens and ``STEPS`` decode steps, under a
    profiler where ``recording``: (prefill logits, scores, the profiler
    or None)."""
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab, (2, 8), generator=g)
    cache = model.init_cache(2, 16, device)

    def run():
        c, logits = model.prefill(params, {"tokens": tokens.to(device)},
                                  cache)
        scores, _ = serve_steps(model, params, c, logits, STEPS)
        return logits, scores

    if not recording:
        return (*run(), None)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
        else [])
    with profile(activities=acts) as prof:
        logits, scores = run()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    return logits, scores, prof


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One arch's smoke model and weights, a warm-up traced run, then a
    traced run's records and profiler, and the logits and scores of an
    untraced run beside the traced run's."""
    model = Model(_cfg(request.param))
    params = model.init(0, "cpu")
    _serve(model, params, "cpu", True)              # the profiler's start-up
    spans.clear()
    logits, scores, prof = _serve(model, params, "cpu", True)
    records = spans.recorded()
    spans.clear()
    plain_logits, plain_scores, _ = _serve(model, params, "cpu", False)
    return types.SimpleNamespace(
        arch=request.param, model=model, records=records, prof=prof,
        traced=(logits, scores), plain=(plain_logits, plain_scores))


def _layers(cfg):
    return [spec for seg in transformer.build_segments(cfg)
            for _ in range(seg.count) for spec in seg.unit]


def _children(records):
    out = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        out.setdefault(r.parent, []).append(r)
    return out


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    spans.clear()

    def refused(*args, **kw):
        raise AssertionError("an off span read the clock or entered "
                             "record_function")

    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        time_ns=refused))
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert spans.span("layer.mixer") is spans.span("serve.step")
    for _ in itertools.repeat(None, 100):
        with spans.span("layer.ffn"):
            pass
    tracemalloc.start()
    try:
        grown = []
        for enter in (False, True):       # the bare loop, then with spans
            tracemalloc.reset_peak()
            before = tracemalloc.get_traced_memory()[0]
            for _ in itertools.repeat(None, 10_000):
                if enter:
                    with spans.span("layer.ffn"):
                        pass
            after, peak = tracemalloc.get_traced_memory()
            grown.append((after - before, peak - before))
    finally:
        tracemalloc.stop()
    assert grown[1] == grown[0]
    assert spans.recorded() == []


def test_off_costs_under_a_microsecond():
    n, best = 100_000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in itertools.repeat(None, n):
            with spans.span("layer.mixer"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best <= 1e-6, f"{best * 1e9:.0f} ns a span"


def test_tree_of_prefill_and_steps(served):
    cfg = served.model.cfg
    layers = _layers(cfg)
    kids = _children(served.records)
    roots = kids[None]
    assert [r.name for r in roots] == ["model.prefill"] + [
        "serve.step"] * STEPS
    for root in roots:
        below = kids[root.id]
        assert [r.name for r in below] == [
            "layer.mixer", "layer.ffn"] * len(layers)
        for spec, mixer, ffn in zip(layers, below[::2], below[1::2]):
            assert mixer.id not in kids
            assert root.start_ns <= mixer.start_ns <= mixer.end_ns <= \
                ffn.start_ns <= ffn.end_ns <= root.end_ns
            moe = kids.get(ffn.id, [])
            assert [r.name for r in moe] == (
                list(MOE) if spec.mlp == "moe" else [])
            assert all(ffn.start_ns <= r.start_ns <= r.end_ns <= ffn.end_ns
                       for r in moe)
    assert len({r.thread for r in served.records}) == 1
    n_moe = sum(spec.mlp == "moe" for spec in layers)
    assert len(served.records) == (1 + STEPS) * (
        1 + 2 * len(layers) + 3 * n_moe)
    assert n_moe == (1 if served.arch == "deepseek-moe-16b" else 0)


def test_records_share_the_profilers_clock():
    """A span between the profiler's own annotation and an operator:
    the record brackets the operator's event and lies inside the
    annotation's, the median edge within 50 us (a single edge is
    stretched now and then by a loaded CPU)."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with torch.profiler.record_function("probe.outer"):
                with spans.span("probe"):
                    torch.ones(4)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ("probe.outer", "aten::ones"):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    records = sorted(spans.recorded(), key=lambda r: r.start_ns)
    spans.clear()
    outer, ones = sorted(events["probe.outer"]), sorted(events["aten::ones"])
    assert len(records) == len(outer) == len(ones) == 20
    edges = []
    for r, (o0, o1), (a0, a1) in zip(records, outer, ones):
        assert o0 <= r.start_ns <= a0 <= a1 <= r.end_ns <= o1
        edges += [r.start_ns - o0, a0 - r.start_ns, r.end_ns - a1,
                  o1 - r.end_ns]
    assert statistics.median(edges) <= 50_000


def test_spans_add_no_event_to_the_trace(served):
    names = {ev.name() for ev in served.prof.profiler.kineto_results.events()}
    assert not names & {"model.prefill", "serve.step", "layer.mixer",
                        "layer.ffn", *MOE}


def test_recorder_leaves_logits_and_scores_bitwise(served):
    for got, want in zip(served.traced, served.plain):
        assert torch.equal(got, want)


def test_threads_keep_separate_stacks():
    spans.clear()
    meet = threading.Barrier(2, timeout=30)

    def lane(tag):
        with spans.span(f"{tag}.outer"):
            meet.wait()
            with spans.span(f"{tag}.inner"):
                meet.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=lane, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = {r.name: r for r in spans.recorded()}
    spans.clear()
    assert set(got) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    for tag in ("a", "b"):
        outer, inner = got[f"{tag}.outer"], got[f"{tag}.inner"]
        assert outer.parent is None and inner.parent == outer.id
        assert outer.thread == inner.thread
    assert got["a.outer"].thread != got["b.outer"].thread


def test_buffer_keeps_the_newest():
    rec = spans.Recorder(keep=4)
    for i in range(6):
        rec.records.append(i)
    assert list(rec.records) == [2, 3, 4, 5]


# ------------------------------------------------------------- on the card --
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_spans_add_no_host_sync(gpu, arch):
    model = Model(_cfg(arch, "pallas"))
    params = model.init(0, gpu)
    _serve(model, params, gpu, True)                # kernels built, warm
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab, (2, 8), generator=g).to(gpu)
    cache = model.init_cache(2, 16, gpu)
    cache, logits = model.prefill(params, {"tokens": tokens}, cache)
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            serve_steps(model, params, cache, logits, STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert sum(r.name == "serve.step" for r in spans.recorded()) == STEPS
    spans.clear()
