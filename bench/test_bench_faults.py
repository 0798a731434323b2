"""The check that decides ``correct`` fails what it must. A run of a toy
cell on the CPU, under the real cells' limits, comes out correct; the
same run with its timed path broken underneath comes out not correct,
once for each fault of ``bench/faults.py``: a decode step that leaves
its state unchanged, half of the batch left out, a fed token altered
where it is produced, an answer (a score) altered where it is produced,
a tile of keys dropped by the prefill's or the decode's attention
kernel; and for the MoE a wrong expert or slot in the routes the
reference follows. The control, the reference computed one precision
below the configuration's, reads above the limits. All of it on the CPU
at toy widths, and on the card at the cells' own sizes (``cuda``)."""
import json

import pytest
import torch

from bench import control, faults, harness, testing

ROOT = testing.ROOT
CELLS = testing.TOY_LIMITS
CARD_CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 11
ROUTE_FAULTS = ("wrong_expert", "wrong_slot")


def _run(tmp_path, config, plant=None):
    root = testing.copy_layout(tmp_path)
    cell = testing.add_toy_cell(root, config, limits_from=CELLS[config])
    undo = []
    try:
        return harness.run(harness.Layout(root), cell, SEED, 0.2, False,
                           device="cpu",
                           break_with=plant and (lambda s: undo.append(
                               plant(s))))
    finally:
        for u in undo:
            u()


@pytest.mark.parametrize("config", sorted(CELLS))
def test_sound_run_is_correct(tmp_path, config):
    r = _run(tmp_path, config)
    assert r.correct, r.checks


@pytest.mark.parametrize("fault", faults.FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("config", sorted(CELLS))
def test_fault_is_not_correct(tmp_path, config, fault):
    r = _run(tmp_path, config, plant=fault)
    assert not r.correct, r.checks


def _failed(reading, limits):
    return any(reading[n] > limits[n] for n in limits)


def _fault_names(cell_traffic, moe):
    return [f.__name__ for f in faults.for_cell(cell_traffic)] + (
        list(ROUTE_FAULTS) if moe else [])


def test_route_faults_are_not_correct(tmp_path):
    root = testing.copy_layout(tmp_path)
    cell = testing.add_toy_cell(root, "deepseek-moe-16b",
                                limits_from=CELLS["deepseek-moe-16b"])
    limits = _limits(CELLS["deepseek-moe-16b"])
    r = control.readings(harness.Layout(root), cell, 4, False, faults=True,
                         device="cpu")
    assert not _failed(r["program"], limits), r
    for name in ROUTE_FAULTS:
        assert _failed(r[name], limits), (name, r)


def _limits(cell):
    return json.loads((ROOT / "bench" / "limits" / f"{cell}.json")
                      .read_text())["limits"]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_control_fails_at_toy_widths(tmp_path, config):
    root = testing.copy_layout(tmp_path)
    cell = testing.add_toy_cell(root, config, limits_from=CELLS[config])
    layout = harness.Layout(root)
    limits = _limits(CELLS[config])
    for seed in (1, 2, 3):
        r = control.readings(layout, cell, seed, True, device="cpu")
        assert any(r["control"][n] > limits[n] for n in limits), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    layout = harness.Layout(ROOT)
    limits = _limits(cell)
    for seed in (101, 102, 103):
        r = control.readings(layout, cell, seed, True)
        assert all(r["program"][n] <= limits[n] for n in limits), r
        assert any(r["control"][n] > limits[n] for n in limits), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_faults_fail_at_cell_size(cell):
    """Each fault the cell can have, planted at the cell's own sizes,
    reads above a limit (the readings: ``limits/<cell>.json``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    layout = harness.Layout(ROOT)
    limits = _limits(cell)
    traffic = harness.ScoreSweep.from_file(
        layout.traffic(layout.cell(cell)["traffic"]))
    moe = "n_routed_experts" in layout.config(layout.cell(cell)["config"])
    names = _fault_names(traffic, moe)
    for seed in (101, 102, 103):
        r = control.readings(layout, cell, seed, False, faults=True)
        assert not _failed(r["program"], limits), r
        for name in names:
            assert _failed(r[name], limits), (name, r)
