"""The attention tape keeps what the cell's kernel numbers need, from the
kernels' own calls: B3's record holds the keys and values B3 was handed,
which on the GQA stacks are the very rows the cache holds for B6, and its
scale, at which the check holds it; a cell that names no kernel number
keeps nothing."""
import pytest
import torch

from bench import compare, harness, tape as tape_lib, testing
from bench.reference import transformer as reference

CELLS = testing.TOY_LIMITS


def _sweep(tmp_path, config):
    root = testing.copy_layout(tmp_path)
    cell = testing.add_toy_cell(root, config, limits_from=CELLS[config])
    layout = harness.Layout(root)
    return harness.Sweep(layout, layout.cell(cell), 2 ** 31 + 3, "cpu")


@pytest.mark.parametrize("config", sorted(CELLS))
def test_flash_reads_b3s_own_rows_as_the_cache_holds_them(tmp_path, config):
    sweep = _sweep(tmp_path, config)
    try:
        _, prompts, fed = sweep.inputs(0)
        sweep.run_batch(prompts, fed, lambda: None)
    finally:
        sweep.close()
    rec = sweep.attn
    S = sweep.traffic.prompt_len
    f, d = rec.flash, rec.decode
    assert f.k.shape[1] == S and d.k.shape[1] == S + sweep.traffic.scored_steps
    assert torch.equal(f.k, d.k[:, :S]) and torch.equal(f.v, d.v[:, :S])
    assert f.scale == f.q.shape[-1] ** -0.5
    from_cache = tape_lib.Record(
        tape_lib.Flash(f.pos, f.q, f.out, d.k[:, :S], d.v[:, :S], f.scale),
        None)
    assert compare.kernels(from_cache)["flash"] == \
        compare.kernels(rec)["flash"] < 0.02


def _plain(q, k, v, causal=True, scale=None):
    """Plain causal attention of every row, at ``scale``."""
    pos = torch.arange(q.shape[1])
    return reference.attend(reference.Products(), q, pos, k, v,
                            scale=scale)


def _tape(checks):
    tape = tape_lib.AttentionTape(1, 2, 16, 5, "cpu", checks)
    tape.flash, tape.decode = _plain, None
    tape.start(True)
    return tape


def test_flash_is_checked_at_the_calls_scale():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 4, 24, generator=g) for _ in range(3))
    tape = _tape(("flash",))
    tape._flash(q, k, v, causal=True, scale=0.5)
    rec = tape.take()
    assert rec.flash.scale == 0.5 and rec.decode is None
    assert compare.kernels(rec) == {"flash": pytest.approx(0.0, abs=1e-6)}
    # a kernel that applied its default scale instead fails the check
    wrong = _plain(q, k, v)
    rec.flash.out = wrong.index_select(1, rec.flash.pos)
    assert compare.kernels(rec)["flash"] > 0.05


def test_a_cell_with_no_kernel_number_keeps_nothing():
    q = torch.zeros(2, 16, 4, 24)
    tape = _tape(())
    tape._flash(q, q, q)
    assert tape.prefill is None and tape.take() is None
    with pytest.raises(ValueError):
        tape_lib.AttentionTape(1, 2, 16, 5, "cpu", ("flash", "mla"))
