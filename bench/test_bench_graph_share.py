"""``decode_graph_share``: the port's ``serve.step`` spans in the traced
batches that hold a ``decode.graph`` span (a step replayed from CUDA
graphs), over all of them. On a synthetic span set of two steps: 0 where
no step replays, 50 and 100 where one and both do, nothing where the
program records no span (a tree without the recorder) or no trace was
taken."""
import sys
import types

import pytest

import repro_torch.common
from bench import trace as trace_lib
from bench.metrics import decode_graph_share
from repro_torch.common import spans as recorder


def _records(graphed):
    """A prefill and two steps, each with a layer; ``decode.graph``
    around the layer of the steps in ``graphed``."""
    out = []

    def span(name, start, end, parent=None):
        out.append(recorder.Record(len(out) + 1, name, start, end,
                                   None if parent is None else parent.id, 1))
        return out[-1]

    pre = span("model.prefill", 100, 1_900)
    span("layer.mixer", 200, 400, pre)
    for i, t0 in enumerate((4_100, 6_100)):
        step = span("serve.step", t0, t0 + 1_500)
        body = span("decode.graph", t0 + 10, t0 + 1_400, step) \
            if i in graphed else step
        mixer = span("layer.mixer", t0 + 100, t0 + 300, body)
        span("moe.route", t0 + 150, t0 + 200, mixer)
    return out


@pytest.mark.parametrize("graphed, share", [((), 0.0), ((1,), 50.0),
                                            ((0, 1), 100.0)])
def test_share_of_steps_replayed(monkeypatch, graphed, share):
    records = _records(graphed)
    monkeypatch.setattr(recorder, "recorded", lambda: list(records))
    ctx = types.SimpleNamespace(trace=trace_lib.Trace(
        [], [("bench.batch", 0, 10_000)], {}, []))
    assert decode_graph_share.read(ctx) == share
    assert decode_graph_share.read(types.SimpleNamespace(trace=None)) is None
    # a tree without the recorder: the import fails
    monkeypatch.delattr(repro_torch.common, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.common.spans", None)
    assert decode_graph_share.read(ctx) is None
