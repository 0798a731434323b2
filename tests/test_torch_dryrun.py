"""``launch/dryrun.py``, ``roofline/render.py`` and
``launch/profile_cell.py`` on the CPU.

(a) The dry run's skipped cells (10 archs x 4 shapes x 2 meshes) are the
    reference's, with its reasons.
(b) ``run_cell`` on the production mesh (a fake group of 256 ranks, in
    a subprocess: the group would outlive the test) for qwen3-8b's
    decode_32k: status ok, the reference's record keys (``t_trace_s`` in
    place of ``t_lower_s``/``t_compile_s``), the memory per card and the
    decode kernel standing in once a layer; and a kernel wrapper handed a
    DTensor raises.
(c) ``render`` makes one row a record: terms for ok, ``skip``, ``ERROR``.
(d) ``profile_cell --one`` prints the terms, the memory and the top
    costs of a cut cell.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.roofline.render import render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, code=None) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable] + (["-c", textwrap.dedent(code)] if code
                              else args)
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def test_skipped_cells_match_reference():
    pytest.importorskip("jax")
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.configs import shape_applicable as ref_applicable
    ours, theirs = {}, {}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = ref_applicable(ref_config(arch), REF_SHAPES[shape])
            for multi in (False, True):
                key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                if not ok:
                    theirs[key] = why
                if ok:
                    continue          # an applicable cell needs the world
                rec = dryrun.run_cell(arch, shape, multi)
                assert rec["status"] == "skipped"
                ours[key] = rec["reason"]
    assert ours == theirs
    assert len(ours) == 16                  # 8 archs x long_500k x 2 meshes


def test_run_cell_on_the_production_mesh():
    out = _run(None, """
        import json, torch
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell("qwen3-8b", "decode_32k", False)
        assert rec["status"] == "ok", rec.get("traceback")
        # a kernel wrapper refuses a DTensor
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.kernels.decode_attention import ops as da
        from repro_torch.kernels.flash_attention import ops as fa
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        q = DTensor.from_local(torch.zeros(1, 4, 2, 8), mesh,
                               [Replicate(), Replicate()], run_check=False)
        for call in (lambda: fa.flash_attention_auto(q, q, q),
                     lambda: da.decode_attention_auto(q[:, :1], q, q, 3)):
            try:
                call()
            except TypeError as e:
                assert "DTensor" in str(e)
            else:
                raise AssertionError("a wrapper took a DTensor")
        print(json.dumps(rec))
    """)
    rec = json.loads(out.strip().splitlines()[-1])
    assert {"arch", "shape", "mesh", "status", "params", "active_params",
            "optimizer", "t_trace_s", "memory", "kernels",
            "roofline"} <= set(rec)
    assert rec["mesh"] == "pod16x16" and rec["optimizer"] is None
    assert rec["kernels"] == {"decode_attention": 36}
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes",
                        "temp_peak_bytes", "fits"}
    assert mem["fits"] and mem["argument_bytes"] > 0
    r = rec["roofline"]
    assert r["chips"] == 256 and r["bottleneck"] in (
        "compute", "memory", "collective")
    assert r["flops_per_chip"] > 0 and r["coll_bytes_per_chip"] > 0


def test_render_rows():
    recs = {"a|x|single": {"arch": "a", "shape": "x", "mesh": "pod16x16",
                           "status": "skipped", "reason": "no"},
            "a|y|single": {"arch": "a", "shape": "y", "mesh": "pod16x16",
                           "status": "error", "error": "E"},
            "a|z|single": {"arch": "a", "shape": "z", "mesh": "pod16x16",
                           "status": "ok",
                           "memory": {"temp_peak_bytes": 3e9},
                           "roofline": {"bottleneck": "memory",
                                        "t_compute": 1.0, "t_memory": 2.0,
                                        "t_collective": 0.5,
                                        "useful_flops_ratio": 0.9,
                                        "mfu_bound": 0.25}}}
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(recs, f)
    try:
        rows = render([f.name]).splitlines()
    finally:
        os.unlink(f.name)
    assert len(rows) == 5
    assert "| a | x | pod16x16 | skip |" in rows[2]
    assert "| a | y | pod16x16 | ERROR |" in rows[3]
    assert rows[4] == ("| a | z | pod16x16 | memo | 1.00e+00 | 2.00e+00 | "
                       "5.00e-01 | 0.90 | 0.2500 | 3 |")


def test_profile_cell_one_device_on_the_cpu():
    out = _run(["-m", "repro_torch.launch.profile_cell", "--arch",
                "qwen3-8b", "--shape", "prefill_32k", "--one", "--batch",
                "1", "--seq", "4096", "--top", "3"])
    assert "=== qwen3-8b | prefill_32k | one | cut" in out
    assert "bottleneck: " in out and "fits: True" in out
    assert "kernels: {'flash_attention': 36}" in out
    assert "== top flops" in out


def test_profile_cell_card_needs_one_device():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.launch.profile_cell", "--arch",
                        "qwen3-8b", "--shape", "decode_32k", "--device",
                        "cuda"], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=120)
    assert r.returncode != 0 and "--one" in r.stderr
