"""The placement of device operations in the port's spans (``spans.py``)
and the five readers that use it: ``attn_device_share``,
``ffn_device_share``, ``ffn_gemm_share``, ``decode_host_ms_step`` and
``decode_busy_ms_step``.

On a synthetic ``trace.Trace``: an operation with a known launch goes in
the innermost span around the launch, one with no launch in the innermost
span around both neighbours' launches, one launched outside every span
nowhere. Each reader reads above 0 on a dense and on a MoE span set;
the device readers report nothing without device operations, and every
reader nothing where the program records no span (a tree without the
recorder). The traced toy harness of both stacks reports
``decode_host_ms_step`` on the CPU. On the card: every B4 launch lies
inside a ``serve.step`` span, every operation launched inside a
``model.prefill`` or ``serve.step`` span, or lying between two such, is
placed in it, and the spans add no device operation.
"""
import importlib
import sys
import types

import pytest
import torch

import repro_torch.common
from bench import harness, spans, testing, trace as trace_lib
from repro_torch.common import spans as recorder

READERS = ("attn_device_share", "ffn_device_share", "ffn_gemm_share",
           "decode_host_ms_step", "decode_busy_ms_step")
DEVICE_READERS = tuple(r for r in READERS if r != "decode_host_ms_step")
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def _reader(name):
    return importlib.import_module(f"bench.metrics.{name}").read


class Synth:
    """A synthetic window: program spans (``span``) and device operations
    (``op``: launched at a host time, or with no launch the trace
    holds), in one ``bench.batch`` of 0 to 10,000 ns."""

    def __init__(self):
        self.records, self.ops, self.launches = [], [], {}

    def span(self, name, start, end, parent=None):
        rid = len(self.records) + 1
        self.records.append(recorder.Record(
            rid, name, start, end, None if parent is None else parent.id, 1))
        return self.records[-1]

    def op(self, name, launch, start, end):
        corr = len(self.ops) + 1
        self.ops.append((name, start, end, corr, "kernel"))
        if launch is not None:
            self.launches[corr] = launch

    def trace(self):
        return trace_lib.Trace(
            list(self.ops), [("bench.batch", 0, 10_000),
                             ("bench.prefill", 0, 4_000),
                             ("bench.decode", 4_000, 10_000)],
            dict(self.launches), [])


def _layer(s, parent, t0, moe: bool):
    """One layer in ``parent`` from host time t0 (500 ns): its spans and
    device operations, a product in each half."""
    mixer = s.span("layer.mixer", t0, t0 + 200, parent)
    s.op("flash_fwd_wgmma_kernel", t0 + 50, t0 + 1_000, t0 + 1_100)
    ffn = s.span("layer.ffn", t0 + 200, t0 + 480, parent)
    if moe:
        s.span("moe.route", t0 + 210, t0 + 260, ffn)
        s.op("elementwise_kernel", t0 + 220, t0 + 1_100, t0 + 1_150)
        s.span("moe.dispatch", t0 + 260, t0 + 300, ffn)
        s.op("index_kernel", None, t0 + 1_150, t0 + 1_200)
        s.op("index_kernel", t0 + 280, t0 + 1_200, t0 + 1_210)
        s.span("moe.combine", t0 + 400, t0 + 470, ffn)
        s.op("direct_copy_kernel", t0 + 410, t0 + 1_300, t0 + 1_340)
    s.op("nvjet_tst_128x8_NNT", t0 + 310, t0 + 1_210, t0 + 1_300)
    return mixer, ffn


def _window(moe: bool) -> Synth:
    s = Synth()
    pre = s.span("model.prefill", 100, 1_900)
    _layer(s, pre, 200, moe)
    _layer(s, pre, 800, moe)
    s.op("isfinite", 1_950, 3_000, 3_010)            # outside every span
    for t0 in (4_100, 6_100):
        step = s.span("serve.step", t0, t0 + 1_500)
        _layer(s, step, t0 + 100, moe)
        _layer(s, step, t0 + 700, moe)
        s.op("uncertainty_stats_split_kernel", t0 + 1_400, t0 + 1_700,
             t0 + 1_800)
    return s


@pytest.fixture
def recorded(monkeypatch):
    """Stand a synthetic window's records in for the recorder's."""
    def use(s: Synth):
        monkeypatch.setattr(recorder, "recorded", lambda: list(s.records))
        return types.SimpleNamespace(trace=s.trace())
    return use


def test_placement_by_launch_neighbours_and_nowhere():
    s = Synth()
    pre = s.span("model.prefill", 100, 900)
    mixer = s.span("layer.mixer", 200, 400, pre)
    ffn = s.span("layer.ffn", 400, 600, pre)
    s.op("a", 250, 1_000, 1_100)          # launch in the mixer
    s.op("b", None, 1_100, 1_200)         # no launch: mixer either side
    s.op("c", 300, 1_200, 1_300)
    s.op("d", None, 1_300, 1_400)         # no launch: mixer, then ffn
    s.op("e", 450, 1_400, 1_500)
    s.op("f", 950, 1_500, 1_600)          # launched outside every span
    s.op("g", None, 1_600, 1_700)         # no launch and no later one
    placed = spans.Placed(s.trace(), s.records)
    got = {op[0]: (sid, how) for op, sid, how in placed.ops}
    assert got == {"a": (mixer.id, spans.LAUNCH),
                   "b": (mixer.id, spans.NEIGHBOURS),
                   "c": (mixer.id, spans.LAUNCH),
                   "d": (pre.id, spans.NEIGHBOURS),
                   "e": (ffn.id, spans.LAUNCH),
                   "f": (None, spans.LAUNCH),
                   "g": (None, spans.NEIGHBOURS)}
    assert [op[0] for op in placed.within("model.prefill")] == list("abcde")
    assert placed.union_s("layer.mixer") == 300 / 1e9
    assert placed.shares() == {"launch": 300 / 1e9, "neighbours": 200 / 1e9,
                               "outside": 100 / 1e9, "unplaced": 100 / 1e9}


def test_idle_gaps_by_the_span_that_ended_them():
    s = _window(moe=False)
    placed = spans.Placed(s.trace(), s.records)
    gaps = placed.idle_by_span()
    assert set(gaps) <= {"layer.mixer", "layer.ffn", "serve.step",
                         "outside"}
    assert gaps and all(v > 0 for v in gaps.values())


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("name", READERS)
def test_reader_reads_above_zero(recorded, name, moe):
    ctx = recorded(_window(moe))
    value = _reader(name)(ctx)
    assert value is not None and value > 0
    if name.endswith("share"):
        assert value <= 100


def test_device_shares_add_up(recorded):
    ctx = recorded(_window(moe=True))
    attn = _reader("attn_device_share")(ctx)
    ffn = _reader("ffn_device_share")(ctx)
    assert attn + ffn <= 100


@pytest.mark.parametrize("name", DEVICE_READERS)
def test_device_reader_reports_nothing_without_device_ops(recorded, name):
    s = _window(moe=True)
    s.ops = []
    assert _reader(name)(recorded(s)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_without_the_recorder(recorded, monkeypatch,
                                                    name):
    ctx = recorded(_window(moe=True))
    assert _reader(name)(ctx) is not None
    # a tree without the recorder: the import fails
    monkeypatch.delattr(repro_torch.common, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.common.spans", None)
    assert _reader(name)(ctx) is None
    assert _reader(name)(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("config", sorted(testing.TOY_WIDTHS))
def test_traced_toy_harness_reports_host_ms_a_step(tmp_path, config):
    root = testing.copy_layout(tmp_path)
    cell = testing.add_toy_cell(root, config)
    layout = harness.Layout(root)
    assert set(READERS) <= {m["name"] for m in layout.metrics(cell, True)}
    r = harness.run(layout, cell, 2 ** 31 + 7, 0.3, True, device="cpu")
    assert r.correct and r.metrics["decode_host_ms_step"]["value"] > 0
    assert not set(DEVICE_READERS) & set(r.metrics)   # no device here


# ------------------------------------------------------------- on the card --
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _traced_batch(arch, gpu):
    """A smoke model's prefill and 3 scored steps on the card inside a
    ``bench.batch`` span, traced after one warm-up batch: the profiler's
    trace."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.launch.serve import serve_steps
    from repro_torch.models.transformer import Model
    model = Model(dataclasses.replace(configs.get_smoke_config(arch),
                                      attention_impl="pallas"))
    params = model.init(0, gpu)
    tokens = torch.randint(0, model.cfg.vocab, (2, 8), device=gpu)
    cache = model.init_cache(2, 16, gpu)

    def batch():
        c, logits = model.prefill(params, {"tokens": tokens}, cache)
        serve_steps(model, params, c, logits, 3)
        torch.cuda.synchronize()

    batch()
    recorder.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.batch"):
            batch()
    return trace_lib.read(prof)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-20b", "deepseek-moe-16b"])
def test_cuda_ops_placed_in_their_spans(gpu, arch):
    """Each B4 launch (the runtime's clock) lies inside a ``serve.step``
    record (``time.time_ns``); every operation launched inside a
    ``model.prefill`` or ``serve.step`` record, and every one with no
    launch the trace holds between that record's first and last
    launched operations, is placed in it; the three steps place the
    same kernels; the spans add no device operation."""
    tr = _traced_batch(arch, gpu)
    placed = spans.place(tr)
    assert placed is not None
    assert not any(op[0] in ("model.prefill", "serve.step", "layer.mixer",
                             "layer.ffn") + MOE_SPANS for op in tr.ops)
    steps = spans.program_spans(tr, "serve.step")
    assert len(steps) == 3
    b4 = [op for op in tr.ops if "uncertainty_stats_split_kernel" in op[0]]
    assert len(b4) == 3
    for op in b4:
        t = tr.launches[op[3]]
        assert any(r.start_ns <= t <= r.end_ns for r in steps)
    for r in spans.program_spans(tr, "model.prefill") + steps:
        mine = [i for i, (op, _, how) in enumerate(placed.ops)
                if how == spans.LAUNCH
                and r.start_ns <= tr.launches[op[3]] <= r.end_ns]
        assert mine
        for op, sid, _ in placed.ops[mine[0]:mine[-1] + 1]:
            assert r.id in placed.chain(sid), op[0]
    per_step = [sorted(op[0] for op, sid, _ in placed.ops
                       if op[4] == "kernel" and r.id in placed.chain(sid))
                for r in steps]
    assert per_step[0] and per_step[0] == per_step[1] == per_step[2]
