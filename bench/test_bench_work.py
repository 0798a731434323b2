"""The work counts of ``bench/work.py`` against counts made by hand from
the published shapes."""
import json

import pytest

from bench import testing, work
from bench.traffic import ScoreSweep


def _conf(name):
    return json.loads((testing.ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def test_internlm2_20b_counts():
    s = work.Shapes.from_config(_conf("internlm2-20b"))
    d, hd, ff, L = 6144, 128, 16384, 48
    per_layer = d * hd * (48 + 2 * 8) + 48 * hd * d + 3 * d * ff
    assert s.active_params() == L * per_layer == 18_723_373_056
    assert s.head_params() == d * 92_544
    # one 32,768-token document, its last position's logits, no steps
    w = work.BatchWork(s, batch=1, prompt_len=32_768, steps=0)
    attn = 4 * hd * 48 * L * (32_768 * 32_769 // 2)
    assert w.model_flops() == 2 * 18_723_373_056 * 32_768 + 2 * d * 92_544 \
        + attn
    assert w.model_flops() == pytest.approx(1.86e15, rel=0.005)
    # B3's bound at 32k is its FLOPs: 4 * hd * H * pairs a layer
    assert w.flash_bound_s() == pytest.approx(
        L * 4 * hd * 48 * (32_768 * 32_769 // 2) / 989e12)


def test_deepseek_moe_16b_counts():
    s = work.Shapes.from_config(_conf("deepseek-moe-16b"))
    d, hd, L = 2048, 128, 28
    attn = d * hd * 3 * 16 + 16 * hd * d
    dense = 3 * d * 10_944
    moe = d * 64 + (6 + 2) * 3 * d * 1408
    assert s.active_params() == L * attn + dense + (L - 1) * moe
    assert s.active_params() == pytest.approx(2.41e9, rel=0.002)


def test_decode_and_scoring_bytes():
    conf = _conf("deepseek-moe-16b")
    t = ScoreSweep.from_file(json.loads(
        (testing.ROOT / "bench" / "traffic" / "score_docs.json")
        .read_text()))
    w = work.batch_work(conf, t)
    # 16 documents, steps at 4,097..4,104 live positions, 16 KV heads of
    # 128 in bf16, K and V, plus q and o of 16 heads, every layer
    live = sum(4096 + k for k in range(1, 9))
    nbytes = 16 * (live * 2 * 16 * 128 * 2 + 8 * 2 * 16 * 128 * 2) * 28
    assert w.decode_attn_bound_s() == pytest.approx(nbytes / 3.35e12)
    assert w.unc_bound_s() == pytest.approx(
        8 * 16 * (102_400 + 4) * 4 / 3.35e12)
    assert w.tokens == 16 * (4096 + 8)


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (testing.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_arch_work_count_is_the_shapes_count(cell):
    """The accepted configurations' arch modules count a batch's work as
    ``work.batch_work`` does from the published shapes, field for field."""
    from bench import harness
    layout = harness.Layout(testing.ROOT)
    w = layout.cell(cell)
    conf = layout.config(w["config"])
    t = ScoreSweep.from_file(layout.traffic(w["traffic"]))
    got, want = layout.arch(conf).batch_work(conf, t), work.batch_work(conf, t)
    assert got == want
    for name in ("model_flops", "flash_bound_s", "decode_attn_bound_s",
                 "unc_bound_s"):
        assert getattr(got, name)() == getattr(want, name)(), name
    assert got.tokens == want.tokens == t.batch * t.positions
