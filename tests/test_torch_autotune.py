"""The port's block picker (``kernels/pairwise/autotune.py``) against the
reference's ``autotune_blocks``: twins of tests/test_kernels.py's picker
tests, plus the port's own rules — its CPU pick equals the reference's
model pick, ``r_block`` is the reference's model pick for every N (a
measured pick never changes it), and a measured winner persists to disk
and is read back without measuring again. The measurement itself runs only
on the card; here it is replaced by fixed timings.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels.pairwise import autotune

GRID = [(96, 16), (400, 32), (2048, 64), (4096, 192), (10_000, 512),
        (16_666, 512), (16_667, 512), (50_000, 512), (2_048, 4_096),
        (683, 4_096), (4096, 8192)]


@pytest.fixture
def hermetic(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE_DIR", "")
    autotune.clear_cache()
    yield
    autotune.clear_cache()


@pytest.fixture
def on_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE_DIR", str(tmp_path))
    autotune.clear_cache()
    yield tmp_path
    autotune.clear_cache()


def test_autotune_blocks_cached_and_feasible(hermetic):
    ch = autotune.autotune_blocks(4096, 64, torch.float32, measure=False)
    assert ch.n_block in autotune.N_BLOCK_CANDIDATES
    assert ch.r_block in autotune.R_BLOCK_CANDIDATES
    assert autotune.tile_vmem_bytes(64, 4, ch.n_block, ch.r_block) \
        <= autotune.VMEM_BUDGET_BYTES
    assert autotune.hopper_feasible(64, ch.n_block)
    assert autotune.autotune_blocks(4096, 64, torch.float32) is ch  # cached
    assert (4096, 64, "float32", "round") in autotune.report()
    # the gated round is a SEPARATE cache entry
    ch_gated = autotune.autotune_blocks(4096, 64, torch.float32,
                                        measure=False, variant="gated")
    assert (4096, 64, "float32", "gated") in autotune.report()
    assert autotune.autotune_blocks(
        4096, 64, torch.float32, variant="gated") is ch_gated
    assert autotune.autotune_blocks(4096, 64, torch.float32) is ch
    with pytest.raises(ValueError, match="variant"):
        autotune.autotune_blocks(4096, 64, torch.float32, variant="bogus")
    ch_wide = autotune.autotune_blocks(4096, 8192, torch.float32,
                                       measure=False)
    assert autotune.tile_vmem_bytes(8192, 4, ch_wide.n_block,
                                    ch_wide.r_block) \
        <= autotune.VMEM_BUDGET_BYTES
    assert ch_wide.n_block <= ch.n_block
    # Hopper: no row or center stays on chip, so every width launches; a
    # CTA needs a row
    assert autotune.hopper_feasible(16_383, 1024)
    assert autotune.hopper_feasible(16_384, 64)
    assert not autotune.hopper_feasible(64, 0)


def test_autotune_disk_cache_roundtrip(on_disk):
    ch = autotune.autotune_blocks(2048, 32, torch.float32, measure=False)
    entry = on_disk / "n2048_d32_float32_round.json"
    assert entry.exists()
    autotune.clear_cache()                       # simulate a fresh process
    assert autotune.autotune_blocks(2048, 32, torch.float32,
                                    measure=False) == ch
    entry.write_text("not json")                 # corrupt: re-tune, rewrite
    autotune.clear_cache()
    assert autotune.autotune_blocks(2048, 32, torch.float32,
                                    measure=False) == ch
    assert entry.read_text() != "not json"
    autotune.autotune_blocks(2048, 32, torch.float32, measure=False,
                             variant="gated")
    assert (on_disk / "n2048_d32_float32_gated.json").exists()
    # a stale format, or a well-formed entry the current rules reject
    # (an r_block that is not the model's), is ignored and re-tuned
    for bad in ({"format": 0}, {"r_block": 8}):
        raw = json.loads(entry.read_text())
        raw.update(bad)
        entry.write_text(json.dumps(raw))
        autotune.clear_cache()
        assert autotune.autotune_blocks(2048, 32, torch.float32,
                                        measure=False) == ch
    on_disk_now = sorted(p.name for p in on_disk.iterdir())
    assert not [n for n in on_disk_now if ".tmp." in n]   # renamed into place


def test_disabled_disk_cache_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE_DIR", "")
    autotune.clear_cache()
    assert autotune.cache_dir() is None
    autotune.autotune_blocks(1024, 16, torch.float32, measure=False)
    assert not list(tmp_path.iterdir())
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE_DIR")
    assert autotune.cache_dir().endswith(
        "/.cache/repro_torch/pairwise-autotune")
    autotune.clear_cache()


def test_autotune_model_amortizes_r_block():
    per_center = [autotune.round_hbm_bytes(4096, 64, 4, 256, rb) / rb
                  for rb in autotune.R_BLOCK_CANDIDATES]
    assert all(a >= b for a, b in zip(per_center, per_center[1:]))


@pytest.mark.parametrize("n,d", GRID)
def test_cpu_pick_matches_reference(hermetic, monkeypatch, n, d):
    pytest.importorskip("jax")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", "")
    from repro.kernels.pairwise import autotune as ref_autotune
    ref_autotune.clear_cache()
    for variant in autotune.VARIANTS:
        want = ref_autotune.autotune_blocks(n, d, measure=False,
                                            variant=variant)
        got = autotune.autotune_blocks(n, d, measure=False, variant=variant)
        assert (got.n_block, got.r_block, got.source) == \
            (want.n_block, want.r_block, want.source)
        assert got.hbm_bytes == want.hbm_bytes
    ref_autotune.clear_cache()


@pytest.mark.parametrize("pool", [50_000, 2_048, 4_096])
def test_r_block_is_the_model_pick_for_shard_and_pool(hermetic, monkeypatch,
                                                     pool):
    """A shard's r_block and the whole pool's are each the reference's
    model pick at that N — on the CPU and after a measurement on the card
    alike. (At d = 512 the model itself picks 512 for a 16,667-row shard
    and 256 for the 50,000-row pool; chunks of both sizes fold a 1,000-row
    labeled set without a one-center chunk, so the floats agree.)"""
    pytest.importorskip("jax")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE_DIR", "")
    from repro.kernels.pairwise import autotune as ref_autotune
    monkeypatch.setattr(autotune, "_measure",
                        lambda n, d, dt, dev, v, nbs: {nb: 1.0 / nb
                                                       for nb in nbs})
    d = 512 if pool == 50_000 else 4_096
    for n in (pool, -(-pool // 3), pool // 3):
        want = ref_autotune.autotune_blocks(n, d, measure=False).r_block
        assert autotune.model_blocks(n, d).r_block == want
        assert autotune.autotune_blocks(n, d, measure=False).r_block == want
        measured = autotune.autotune_blocks(n, d, measure=True)
        assert measured.source == "measured" and measured.r_block == want
        if pool == 50_000:
            assert 1000 % want != 1     # no one-center chunk
    ref_autotune.clear_cache()


def test_measured_winner_persists_and_is_read_back(on_disk, monkeypatch):
    calls = []

    def fake_measure(n, d, dtype, device, variant, n_blocks):
        calls.append(variant)
        # a winner the model would not pick: the smallest block
        return {nb: 1e-3 * (1 + np.log2(nb)) for nb in n_blocks}

    monkeypatch.setattr(autotune, "_measure", fake_measure)
    for variant in autotune.VARIANTS:
        ch = autotune.autotune_blocks(50_000, 512, measure=True,
                                      variant=variant)
        assert ch.source == "measured" and ch.n_block == 64
        assert ch.r_block == autotune.model_blocks(50_000, 512).r_block
        assert [nb for nb, _ in ch.timed] == list(
            autotune.N_BLOCK_CANDIDATES)
        assert ch.wall_s == dict(ch.timed)[64]
    assert calls == ["round", "gated"]
    autotune.clear_cache()                       # a fresh process
    for variant in autotune.VARIANTS:
        again = autotune.autotune_blocks(50_000, 512, measure=True,
                                         variant=variant)
        assert again.source == "measured" and again.n_block == 64
    assert calls == ["round", "gated"]           # read back, not re-measured
    # a model-only entry does not satisfy a measuring run
    autotune.autotune_blocks(4096, 64, measure=False)
    autotune.clear_cache()
    assert autotune.autotune_blocks(4096, 64, measure=True).source == \
        "measured"
    assert calls[-1] == "round"


@pytest.mark.parametrize("stale", [{"body": "0" * 12}, {"format": 1},
                                   {"body": None}])
def test_entry_of_another_round_body_is_re_tuned(on_disk, monkeypatch,
                                                 stale):
    """A winner measured on another version of the kernel source (or in an
    older entry format) is ignored and measured again."""
    calls = []

    def fake_measure(n, d, dtype, device, variant, n_blocks):
        calls.append(variant)
        return {nb: 1e-3 * (1 + np.log2(nb)) for nb in n_blocks}

    monkeypatch.setattr(autotune, "_measure", fake_measure)
    for variant in autotune.VARIANTS:
        autotune.autotune_blocks(50_000, 512, measure=True, variant=variant)
        path = on_disk / f"n50000_d512_float32_{variant}.json"
        raw = json.loads(path.read_text())
        assert raw["body"] == autotune.body_version(variant)
        raw.update(stale)
        if raw["body"] is None:
            del raw["body"]
        path.write_text(json.dumps(raw))
    autotune.clear_cache()
    for variant in autotune.VARIANTS:
        ch = autotune.autotune_blocks(50_000, 512, measure=True,
                                      variant=variant)
        assert ch.source == "measured"
    assert calls == ["round", "gated"] * 2          # both re-measured
    assert autotune.body_version("round") != autotune.body_version("gated")


def test_measure_defaults_to_the_pool_device(hermetic, monkeypatch):
    seen = []
    monkeypatch.setattr(autotune, "_measure",
                        lambda n, d, dt, dev, v, nbs: seen.append(dev) or
                        {nb: 1.0 for nb in nbs})
    assert autotune.autotune_blocks(300, 8, device="cpu").source == "model"
    assert not seen
    ch = autotune.autotune_blocks(300, 8, device=torch.device("cuda", 0))
    assert ch.source == "measured" and seen == [torch.device("cuda", 0)]
    assert ch.n_block == max(autotune.N_BLOCK_CANDIDATES)   # ties: larger
