"""A decode step replayed from CUDA graphs (``models/decode_graphs.py``).

Which stacks take the graph path: the global-attention stacks with an
MLP or a MoE; RWKV, Griffin (local attention), whisper
(cross-attention) and MLA do not. On the CPU the path never engages:
the counters stay 0 and ``decode_step`` is bitwise the eager step. The
counters count and zero.

A stand-in for torch's CUDA graph on the CPU (``_Recorded``: a capture
records each aten op with the tensors it was handed and produced; a
replay runs them again and writes each result over the tensor the
capture produced, as a graph's static memory holds it) runs the step's
logic here, on the smoke configs of the dense and the MoE stack: over
8 steps with a ``RouteTape`` recording, then forcing recorded routes
and routes of its own, the logits, the cache and ``len`` are bitwise
the eager path's, every step's logits are a tensor of their own, and
the counters read one eager warm-up, one capture, then replays. A step
over a cloned cache runs eagerly and leaves the real cache unchanged. A
replayed step keeps the spans of an eager one, inside a
``decode.graph`` span. A graph set's inputs are held weakly, by
identity.

On the card (``cuda``), at published widths and 2-3 layers, the real
graphs: the same bitwise agreement with the eager path, the counters,
a cloned cache run eagerly, and a new cache, once the captured one is
freed, warmed up and captured anew; the graphs hold neither the model
nor its weights, which go as soon as their last reference does.
"""
import dataclasses
import gc
import types
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.common import spans
from repro_torch.launch.serve import serve_steps
from repro_torch.models import decode_graphs
from repro_torch.models.layers.moe import Routes, RouteTape
from repro_torch.models.transformer import Model

ARCHS = ("internlm2-20b", "deepseek-moe-16b")
GRAPHABLE = {"internlm2-20b": True, "deepseek-moe-16b": True,
             "qwen3-8b": True, "phi3-medium-14b": True, "qwen1.5-4b": True,
             "llava-next-34b": True, "rwkv6-3b": False,
             "recurrentgemma-2b": False, "whisper-medium": False,
             "deepseek-v3-671b": False}
STEPS = 8
B, PROMPT = 4, 8


def _bits(t):
    """A tensor's bits, NaNs included."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def _bitwise(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _inputs(cfg, device, steps=STEPS, batch=B, prompt=PROMPT):
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=g)
    feed = torch.randint(0, cfg.vocab, (steps, batch, 1), generator=g)
    return tokens.to(device), feed.to(device=device, dtype=torch.int32)


def _serve(model, params, tokens, feed, step=None, room=0):
    """A prefill and ``len(feed)`` fed steps through ``step`` (the model's
    ``decode_step`` by default), in a cache with ``room`` positions to
    spare: (every step's logits, the cache)."""
    step = step or model.decode_step
    cache = model.init_cache(tokens.shape[0],
                             tokens.shape[1] + feed.shape[0] + room,
                             tokens.device)
    cache, _ = model.prefill(params, {"tokens": tokens}, cache)
    outs = []
    for tok in feed:
        logits, cache = step(params, cache, tok)
        outs.append(logits)
    return outs, cache


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _eager(model):
    return torch.inference_mode()(model._decode_eager)


def _counts(captures, replayed, eager):
    return {"captures": captures, "replayed_steps": replayed,
            "eager_steps": eager}


@pytest.fixture(autouse=True)
def zeroed():
    decode_graphs.reset_counts()
    yield
    decode_graphs.reset_counts()


@pytest.mark.parametrize("arch", sorted(GRAPHABLE))
def test_graphable_by_layer_kind(arch):
    cfg = configs.get_smoke_config(arch)
    assert decode_graphs.graphable(cfg) is GRAPHABLE[arch]
    assert (Model(cfg)._graphs is not None) is GRAPHABLE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_steps_stay_eager_bitwise(arch):
    model = Model(configs.get_smoke_config(arch))
    params = model.init(0, "cpu")
    tokens, feed = _inputs(model.cfg, "cpu", steps=3)
    got = _serve(model, params, tokens, feed)
    want = _serve(model, params, tokens, feed, _eager(model))
    assert _bitwise(got, want)
    assert decode_graphs.COUNTS == _counts(0, 0, 0)


def test_counts_count_and_zero():
    for name in decode_graphs.COUNTS:
        decode_graphs.launches.bump(decode_graphs.COUNTS, name, 3)
    assert decode_graphs.COUNTS == _counts(3, 3, 3)
    decode_graphs.reset_counts()
    assert decode_graphs.COUNTS == _counts(0, 0, 0)


# ------------------------------------------------ the CPU stand-in graphs --
class _Recording(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _Recorded:
    """``torch.cuda.CUDAGraph`` on the CPU: the ops a capture ran, with
    the tensors they were handed, run again at each replay, each result
    written over the tensor the capture produced."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.rec = _Recording()
        self.rec.__enter__()

    def capture_end(self):
        self.rec.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.rec.ops:
            new = func(*args, **kwargs)
            for o, n in zip(tree_leaves(out), tree_leaves(new)):
                if isinstance(o, torch.Tensor) and o is not n:
                    o.copy_(n)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: a step handed to the model's
    ``DecodeGraphs`` as on a CUDA device, with ``_Recorded`` graphs."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recorded)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(decode_graphs.DecodeGraphs, "_on_side",
                        lambda self, fn: fn())

    def graphed(model):
        return torch.inference_mode()(
            lambda *args: model._graphs.step(model, *args))
    return graphed


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_in_replays_bitwise_the_eager_path(stand_in, arch):
    cfg = configs.get_smoke_config(arch)
    tokens, feed = _inputs(cfg, "cpu")
    params = Model(cfg).init(0, "cpu")

    def run(graphed, force=None):
        tape = RouteTape(force=force) if cfg.moe is not None else None
        model = Model(cfg, routes=tape)
        step = stand_in(model) if graphed else _eager(model)
        decode_graphs.reset_counts()
        outs, cache = _serve(model, params, tokens, feed, step)
        return outs, cache, tape, dict(decode_graphs.COUNTS)

    want, want_cache, want_tape, counts = run(False)
    assert counts == _counts(0, 0, 0)
    got, got_cache, tape, counts = run(True)
    assert counts == _counts(1, STEPS - 2, 1)
    assert _bitwise(got, want) and _bitwise(got_cache, want_cache)
    assert int(got_cache["len"]) == PROMPT + STEPS
    assert len({t.data_ptr() for t in got}) == STEPS
    if cfg.moe is None:
        return
    recorded = [(r.topi, r.slot) for r in tape.recorded]
    assert len(recorded) == 1 + STEPS         # the prefill's, each step's
    assert _bitwise(recorded, [(r.topi, r.slot)
                               for r in want_tape.recorded])
    flipped = [Routes(r.topi.flip(-1), r.slot) for r in want_tape.recorded]
    for force in (want_tape.recorded, flipped):
        want, want_cache, _, _ = run(False, force)
        got, got_cache, _, counts = run(True, force)
        assert counts == _counts(1, STEPS - 2, 1)
        assert _bitwise(got, want) and _bitwise(got_cache, want_cache)
    assert not _bitwise(got, run(False)[0])    # the flipped routes tell


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_in_cloned_cache_runs_eagerly(stand_in, arch):
    cfg = configs.get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(0, "cpu")
    tokens, feed = _inputs(cfg, "cpu", steps=3)
    step = stand_in(model)
    _, cache = _serve(model, params, tokens, feed, step, room=1)
    assert decode_graphs.COUNTS == _counts(1, 1, 1)
    before, twin = _clone(cache), _clone(cache)
    got, _ = step(params, _clone(cache), feed[0])
    assert decode_graphs.COUNTS == _counts(1, 1, 2)
    assert _bitwise(cache, before)
    assert _bitwise(got, _eager(model)(params, twin, feed[0])[0])


def test_inputs_by_identity_held_weakly():
    a, b = torch.ones(3), torch.zeros(2)
    inputs = decode_graphs._Inputs([a, b], torch.Size([4, 1]))
    assert inputs.same([a, b], torch.Size([4, 1])) and inputs.alive()
    assert not inputs.same([a, b.clone()], torch.Size([4, 1]))
    assert not inputs.same([a], torch.Size([4, 1]))
    assert not inputs.same([a, b], torch.Size([2, 1]))
    del b
    assert not inputs.alive()


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_in_replayed_step_keeps_the_spans(stand_in, arch):
    cfg = configs.get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(0, "cpu")
    tokens, feed = _inputs(cfg, "cpu", steps=2)
    graphed = stand_in(model)
    _, cache = _serve(model, params, tokens, feed, graphed)   # captured
    decode_graphs.reset_counts()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cache, logits = model.prefill(params, {"tokens": tokens}, cache)
        serve_steps(types.SimpleNamespace(decode_step=graphed), params,
                    cache, logits, 2)
    records = spans.recorded()
    spans.clear()
    assert decode_graphs.COUNTS == _counts(0, 2, 0)
    kids = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        kids.setdefault(r.parent, []).append(r)
    assert [r.name for r in kids[None]] == ["model.prefill"] + [
        "serve.step"] * 2
    n_moe = cfg.n_layers - cfg.moe.first_dense if cfg.moe else 0
    for step in kids[None][1:]:
        (body,) = kids[step.id]
        assert body.name == "decode.graph"
        below = kids[body.id]
        assert [r.name for r in below] == ["layer.mixer",
                                           "layer.ffn"] * cfg.n_layers
        assert [r.name for ffn in below[1::2] for r in kids.get(ffn.id, [])
                ] == ["moe.route", "moe.dispatch", "moe.combine"] * n_moe


# ------------------------------------------------------------- on the card --
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _published(arch):
    """The published widths at 2 (dense) or 3 (one dense, two MoE)
    layers, on the kernel path."""
    cfg = configs.get_config(arch)
    layers = 3 if cfg.moe is not None else 2
    return dataclasses.replace(cfg, n_layers=layers,
                               attention_impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_graphs_replay_bitwise_the_eager_path(gpu, arch):
    cfg = _published(arch)
    tokens, feed = _inputs(cfg, gpu, batch=4, prompt=64)
    params = Model(cfg).init(0, gpu)

    def run(graphed, force=None):
        tape = RouteTape(force=force) if cfg.moe is not None else None
        model = Model(cfg, routes=tape)
        step = model.decode_step if graphed else _eager(model)
        decode_graphs.reset_counts()
        outs, cache = _serve(model, params, tokens, feed, step, room=1)
        torch.cuda.synchronize()
        return model, outs, cache, tape, dict(decode_graphs.COUNTS)

    _, want, want_cache, want_tape, counts = run(False)
    assert counts == _counts(0, 0, 0)
    model, got, cache, tape, counts = run(True)
    assert counts == _counts(1, STEPS - 2, 1)
    assert _bitwise(got, want) and _bitwise(cache, want_cache)
    assert int(cache["len"]) == 64 + STEPS
    assert len({t.data_ptr() for t in got}) == STEPS
    if cfg.moe is not None:
        assert _bitwise([(r.topi, r.slot) for r in tape.recorded],
                        [(r.topi, r.slot) for r in want_tape.recorded])
        _, f_want, f_want_cache, _, _ = run(False, want_tape.recorded)
        _, f_got, f_cache, _, counts = run(True, want_tape.recorded)
        assert counts == _counts(1, STEPS - 2, 1)
        assert _bitwise(f_got, f_want) and _bitwise(f_cache, f_want_cache)
        del f_cache, f_want_cache
    # a cloned cache runs eagerly and leaves the real one as it was
    decode_graphs.reset_counts()
    before = _clone(cache)
    model.decode_step(params, _clone(cache), feed[0])
    torch.cuda.synchronize()
    assert decode_graphs.COUNTS == _counts(0, 0, 1)
    assert _bitwise(cache, before)
    # the captured cache freed: a new one is warmed up and captured
    del cache, before
    decode_graphs.reset_counts()
    again, _ = _serve(model, params, tokens, feed, room=1)
    torch.cuda.synchronize()
    assert decode_graphs.COUNTS == _counts(1, STEPS - 2, 1)
    assert _bitwise(again, got)


@pytest.mark.cuda
def test_cuda_graphs_hold_no_model_and_no_weights(gpu):
    cfg = dataclasses.replace(configs.get_smoke_config("deepseek-moe-16b"),
                              attention_impl="pallas")
    model = Model(cfg)
    params = model.init(0, gpu)
    tokens, feed = _inputs(cfg, gpu, steps=3)
    outs, cache = _serve(model, params, tokens, feed)
    torch.cuda.synchronize()
    assert decode_graphs.COUNTS == _counts(1, 1, 1)
    refs = [weakref.ref(t) for t in tree_leaves(params)] + [
        weakref.ref(model)]
    gc.disable()
    try:
        del model, params, cache, outs
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
