"""The harness is driven by data: ``BENCHMARK.json`` keeps to its
contract, every name in it has its file, and a toy configuration,
traffic mix and per-layer metric, or a toy architecture of a new
``model_type`` (its arch module, reference, work count, spread leaves and
kernel checks), added as new files and new entries in a copy of the
layout are listed, loaded and run on the CPU with no file that was there
edited."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench import harness, testing

ROOT = testing.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_contract_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["source"] == conf["source"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['traffic']}.{w['config']}"
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_name_has_its_file(cell):
    layout = harness.Layout(ROOT)
    w = layout.cell(cell)
    conf = layout.config(w["config"])
    arch = layout.arch(conf)
    cfg = arch.port_config(conf)
    assert cfg.attention_impl == "pallas" and cfg.d_model == \
        conf["hidden_size"]
    assert layout.traffic(w["traffic"])["kind"] == "score_sweep"
    assert callable(arch.reference.forward) and callable(arch.batch_work)
    names = {"logits", "scores"} | set(arch.kernel_checks) | (
        {"routes"} if "n_routed_experts" in conf else set())
    assert set(layout.limits(cell)) == names
    assert layout.qk_logit_std(cell) > 1.0      # attention the check sees
    for trace in (False, True):
        assert all(callable(m["read"]) for m in layout.metrics(cell, trace))
    cells = {c["name"] for c in SPEC["workloads"]}
    assert all(set(m.get("workloads", [])) <= cells
               for m in SPEC["per_layer"] + SPEC["end_to_end"])
    reported = {m["name"] for m in layout.metrics(cell, True)}
    assert reported == {m["name"] for m in SPEC["per_layer"]
                        if cell in m.get("workloads", [cell])}
    # the roofline of every kernel the cell's path runs: B4 each step,
    # B3 and B6 where the arch's kernel checks name them
    runs = {"unc_roofline"} | {f"{k}_roofline" for k in arch.kernel_checks}
    assert runs & {m["name"] for m in SPEC["per_layer"]} <= reported


@pytest.mark.parametrize("config", sorted(testing.TOY_WIDTHS))
def test_toy_cell_added_as_files_runs(tmp_path, config):
    root = testing.copy_layout(tmp_path)
    before = _digest(root)
    cell = testing.add_toy_cell(root, config, metric="toy_batches")
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        f"bench/configs/toy-{config}.json", "bench/traffic/toy_mix.json",
        f"bench/limits/{cell}.json", "bench/metrics/toy_batches.py"}
    layout = harness.Layout(root)
    assert cell in [w["name"] for w in layout.spec["workloads"]]
    r = harness.run(layout, cell, 2 ** 31 + 5, 0.3, False, device="cpu")
    assert r.correct and r.attempted > 0 and r.failed == 0
    assert set(r.metrics) == {"score_tokens_s", "setup_s"}
    r = harness.run(layout, cell, 2 ** 31 + 5, 0.3, True, device="cpu")
    assert r.correct and r.metrics["toy_batches"]["value"] >= 1
    assert {"prefill_tokens_s", "decode_ms_step", "score_mfu"} <= set(
        r.metrics)
    line = json.loads(r.line())
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]


def test_architecture_added_as_files_runs(tmp_path):
    """A toy ``model_type`` (MLA: no B3, no B6) comes as new files only;
    the harness takes its port config, its own reference and work count,
    its spread leaves, and judges the cell on the numbers its limits
    name."""
    root = testing.copy_layout(tmp_path)
    before = _digest(root)
    cell = testing.add_toy_arch(root)
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "bench/archs/toy_mla.py", "bench/reference/toy_mla.py",
        "bench/configs/toy-mla.json", "bench/traffic/toy_mix.json",
        f"bench/limits/{cell}.json"}
    layout = harness.Layout(root)
    assert set(layout.limits(cell)) == {"logits", "scores"}
    arch = layout.arch(layout.config(layout.cell(cell)["config"]))
    assert arch.kernel_checks == () and arch.spread_leaves == ("w_uq",
                                                               "w_uk")
    calls = []
    forward, batch_work = arch.reference.forward, arch.batch_work

    def spy_forward(conf, params, *args, **kw):
        calls.append(("reference", params))
        return forward(conf, params, *args, **kw)

    def spy_work(conf, traffic):
        calls.append(("work", traffic))
        return batch_work(conf, traffic)
    arch.reference.forward, arch.batch_work = spy_forward, spy_work
    for trace in (False, True):
        calls.clear()
        r = harness.run(layout, cell, 2 ** 31 + 7, 0.3, trace, device="cpu")
        assert r.correct and r.attempted > 0 and r.failed == 0, r.checks
        assert set(r.checks) == {"logits", "scores"}
        assert [c for c, _ in calls] == ["work", "reference"]
    assert r.metrics["score_mfu"]["value"] > 0
    mixer = next(iter(calls[1][1]["segments"][0][0].values()))["mixer"]
    # fan-in 32 (q_lora_rank), qk_logit_std 2: std sqrt(2 / 32)
    assert abs(float(mixer["w_uq"].float().std()) / 0.25 - 1) < 0.1
    assert abs(float(mixer["w_dq"].float().std()) / 0.125 - 1) < 0.1


def test_same_seed_same_inputs_and_weights():
    from bench.traffic import Documents, ScoreSweep
    t = ScoreSweep.from_file(testing.toy_traffic())
    a, b = Documents(t, 1000, 2 ** 31 + 9), Documents(t, 1000, 2 ** 31 + 9)
    assert (a.batch(3) == b.batch(3)).all()
    assert not (a.batch(3) == Documents(t, 1000, 7).batch(3)).all()
    assert a.batch(0).shape == (t.batch, t.positions)


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_query_and_key_weights_carry_the_cells_logit_spread():
    import torch
    from bench import weights
    from repro_torch.models.transformer import Model
    conf = testing.toy_config("internlm2-20b")
    arch = harness.Layout(ROOT).arch(conf)
    model = Model(arch.port_config(conf))
    flat, peaked = (weights.make(model.param_decls(), conf["vocab_size"],
                                 3, "cpu", qk_logit_std=s,
                                 spread_leaves=arch.spread_leaves)
                    for s in (1, 4))
    a, b = (next(iter(p["segments"][0][0].values()))["mixer"]
            for p in (flat, peaked))
    for name, ratio in (("w_q", 2.0), ("w_k", 2.0), ("w_v", 1.0),
                        ("w_o", 1.0)):
        assert torch.allclose(b[name].float(), a[name].float() * ratio,
                              rtol=1e-2, atol=1e-6), name


def _std_before(path, decl, qk_logit_std):
    """``weights._std`` as it was with ``w_q`` and ``w_k`` built in."""
    import math
    if decl.init == "embed":
        return 0.02
    std = 1.0 / math.sqrt(decl.shape[-2] if len(decl.shape) > 1 else 1)
    if path[-1] in ("w_q", "w_k"):
        std *= math.sqrt(qk_logit_std)
    return std


@pytest.mark.parametrize("config", sorted(testing.TOY_WIDTHS))
def test_spread_leaves_give_the_weights_as_before(config):
    """The accepted configurations' spread leaves scale every leaf as the
    built-in names did, so ``weights.make`` gives the same tensors."""
    from bench import weights
    from repro_torch.models.transformer import Model
    conf = testing.toy_config(config)
    arch = harness.Layout(ROOT).arch(conf)
    decls = Model(arch.port_config(conf)).param_decls()
    leaves = [(p, d) for p, d in weights._leaves(decls)
              if d.init in ("embed", "normal")]
    assert any(p[-1] == "w_q" for p, _ in leaves)
    for s in (1.0, 2.0, 2.5):
        for path, decl in leaves:
            assert weights._std(path, decl, s, arch.spread_leaves) == \
                _std_before(path, decl, s), path
