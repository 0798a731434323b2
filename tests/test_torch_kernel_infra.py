"""Kernel plumbing that runs without a card: the build cache key covers
the local headers a source includes, and the launch counters and op
accounting stay exact when replica lanes bump them from several threads.
"""
import shutil
import threading

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.pairwise import ops
from repro_torch.kernels.uncertainty import ops as unc_ops


def test_library_path_hashes_local_headers(tmp_path, monkeypatch):
    src = build.SOURCES["gated_greedy_round"]
    copy = tmp_path / src.name
    shutil.copy(src, copy)
    shutil.copy(src.parent / "round_block.cuh", tmp_path / "round_block.cuh")
    monkeypatch.setitem(build.SOURCES, "gated_greedy_round", copy)
    before = build.library_path("gated_greedy_round")
    assert [f.name for f in build._hashed_files(copy)] == [
        "gated_greedy_round.cu", "round_block.cuh"]
    header = tmp_path / "round_block.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = build.library_path("gated_greedy_round")
    assert after != before and after.parent == before.parent
    copy.write_text(copy.read_text() + "\n// another\n")
    assert build.library_path("gated_greedy_round") not in (before, after)


def test_every_source_is_listed_with_its_headers():
    for name, src in build.SOURCES.items():
        assert src.exists(), name
        assert build.library_path(name).name.startswith(name + "-")
    shared = {f.name for f in build._hashed_files(
        build.SOURCES["greedy_round"])}
    assert shared == {"greedy_round.cu", "round_block.cuh"}


def _hammer(fn, threads=8, per_thread=2000):
    ts = [threading.Thread(target=lambda: [fn() for _ in range(per_thread)])
          for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return threads * per_thread


def test_launch_counters_are_exact_under_threads():
    for mod in (ops, fa_ops, unc_ops, da_ops):
        mod.reset_launches()
        name = next(iter(mod.LAUNCHES))
        total = _hammer(lambda: launches.bump(mod.LAUNCHES, name))
        assert mod.LAUNCHES[name] == total
        mod.reset_launches()
        assert set(mod.LAUNCHES.values()) == {0}


def test_op_accounting_is_exact_under_threads():
    x = torch.zeros((10, 4))
    with ops.track_ops() as st:
        n = _hammer(lambda: ops._record(x, emb_reads=1, vec_streams=2),
                    per_thread=500)
        _hammer(lambda: ops.record_pool_rows(3), per_thread=500)
    assert st["embedding_reads"] == n and st["vector_streams"] == 2 * n
    assert st["pool_rows"] == 10 * n + 3 * n
    assert st["hbm_bytes"] == n * 4 * (40 + 20)
