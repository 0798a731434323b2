"""Port parity and hand checks: the dry run's configs fields
(``configs/base.py``), ``roofline/analysis.py`` and the cost walker
``roofline/cost.py``.

(a) ``tp_friendly``, ``active_params``, ``subquadratic``,
    ``shape_applicable`` and ``model_flops`` equal the reference's for the
    10 archs x 4 shapes; ``count_params`` and ``param_bytes`` of every
    arch's declarations equal the reference's; twins of
    ``tests/test_tp_friendly.py``.
(b) ``Roofline``'s terms, bottleneck, bound and ``mfu_bound`` on hand
    numbers; ``group_links`` on a (2, 2, 2) and a (16, 16) mesh.
(c) The cost walker is exact on hand graphs: a matmul chain (FLOPs and
    bytes), views at 0 bytes, an indexed write in place at twice its
    rows, a kernel's stand-in, and one all-reduce of known bytes on a
    fake (2, 2, 2) mesh (a subprocess: a fake process group outlives the
    test that makes it).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.common.param import count_params, param_bytes
from repro_torch.configs import SHAPES, shape_applicable
from repro_torch.models.transformer import Model
from repro_torch.roofline import analysis
from repro_torch.roofline.cost import CostMode

ARCHS = configs.ARCH_IDS
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_fields_match_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.configs import shape_applicable as ref_applicable
    from repro.roofline.analysis import model_flops as ref_model_flops
    ours, theirs = configs.get_config(arch), ref_config(arch)
    assert ours.subquadratic == theirs.subquadratic
    assert ours.active_params() == theirs.active_params()
    for tp in (4, 16):
        a, b = ours.tp_friendly(tp), theirs.tp_friendly(tp)
        assert (a is ours) == (b is theirs)
        for f in ("n_heads", "n_kv_heads", "head_dim", "hd"):
            assert getattr(a, f) == getattr(b, f), (tp, f)
    assert set(SHAPES) == set(REF_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            REF_SHAPES[name])
        assert shape_applicable(ours, shape) == ref_applicable(
            theirs, REF_SHAPES[name])
        assert analysis.model_flops(ours, shape) == ref_model_flops(
            theirs, REF_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_declared_params_match_reference(arch):
    pytest.importorskip("jax")
    from repro.common import param as ref_param
    from repro.configs import get_config as ref_config
    from repro.models.transformer import Model as RefModel
    ours = Model(configs.get_config(arch)).param_decls()
    theirs = RefModel(ref_config(arch)).param_decls()
    assert count_params(ours) == ref_param.count_params(theirs)
    assert param_bytes(ours) == ref_param.param_bytes(theirs)


# -- twins of tests/test_tp_friendly.py --------------------------------------
def test_tp_friendly_pads_hostile_archs():
    phi3 = configs.get_config("phi3-medium-14b").tp_friendly(16)
    assert phi3.n_heads == 48 and phi3.n_kv_heads == 16
    assert phi3.hd == 128                      # head_dim preserved
    llava = configs.get_config("llava-next-34b").tp_friendly(16)
    assert llava.n_heads == 64 and llava.n_kv_heads == 16
    qwen15 = configs.get_config("qwen1.5-4b").tp_friendly(16)
    assert qwen15.n_heads == 32 and qwen15.n_kv_heads == 32


def test_tp_friendly_replicates_kv_when_under_tp():
    q3 = configs.get_config("qwen3-8b").tp_friendly(16)
    assert q3.n_heads == 32 and q3.n_kv_heads == 16   # GQA kv 8 -> 16


def test_tp_friendly_noop_where_inapplicable():
    for arch in ("deepseek-v3-671b", "rwkv6-3b"):
        cfg = configs.get_config(arch)
        assert cfg.tp_friendly(16) is cfg


def test_tp_friendly_model_still_runs():
    cfg = dataclasses.replace(configs.get_smoke_config("phi3-medium-14b"),
                              n_heads=6, n_kv_heads=3)
    padded = cfg.tp_friendly(4)
    assert padded.n_heads == 8
    model = Model(padded)
    params = model.init(0, "cpu")
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.zeros((2, 16), dtype=torch.int32)}
    loss, _ = model.loss(params, batch)
    assert torch.isfinite(loss)


# -- Roofline -----------------------------------------------------------------
def test_roofline_terms_on_hand_numbers():
    r = analysis.Roofline(
        flops_per_chip=2 * analysis.PEAK_FLOPS,       # 2 s of compute
        bytes_per_chip=analysis.HBM_BW,               # 1 s of HBM
        coll_bytes_per_chip=3e9, coll_breakdown={"all_reduce": 3e9},
        chips=4, model_flops_global=4 * analysis.PEAK_FLOPS,
        coll_seconds=0.5)
    assert r.t_compute == pytest.approx(2.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == 0.5
    assert r.bottleneck == "compute" and r.step_time == pytest.approx(2.0)
    # 4 chips x 2 s of peak, of which the model needs 1 s a chip
    assert r.mfu_bound == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    d = r.as_dict()
    assert d["bottleneck"] == "compute" and d["step_time_bound"] == \
        pytest.approx(2.0)
    r.coll_seconds = 3.0
    assert r.bottleneck == "collective"


def test_roofline_keys_match_reference():
    pytest.importorskip("jax")
    from repro.roofline import analysis as ref_analysis
    args = dict(flops_per_chip=1.0, bytes_per_chip=1.0,
                coll_bytes_per_chip=0.0, coll_breakdown={}, chips=1,
                model_flops_global=1.0)
    assert set(analysis.Roofline(**args).as_dict()) == set(
        ref_analysis.Roofline(**args).as_dict())


# -- the cost walker on hand graphs -----------------------------------------
def _count(fn, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = CostMode(attribute=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(a.shape, dtype=a.dtype) for a in args]
        with mode:
            fn(*fake)
    return mode


def test_matmul_chain_is_exact():
    """(8, 16) @ (16, 32) @ (32, 4) in fp32: FLOPs 2*8*16*32 +
    2*8*32*4; bytes each product's inputs and output."""
    x, a, b = torch.ones(8, 16), torch.ones(16, 32), torch.ones(32, 4)
    m = _count(lambda x, a, b: (x @ a) @ b, x, a, b)
    assert m.total.flops == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    assert m.total.bytes == 4 * ((8 * 16 + 16 * 32 + 8 * 32)
                                 + (8 * 32 + 32 * 4 + 8 * 4))
    assert m.total.coll == {} and m.n_ops == 2


def test_views_cost_nothing_and_pointwise_counts_elements():
    x = torch.ones(4, 6, dtype=torch.bfloat16)
    m = _count(lambda x: x.view(6, 4).t()[1:3].unsqueeze(0).expand(5, 2, 6),
               x)
    assert (m.total.flops, m.total.bytes, m.n_ops) == (0.0, 0.0, 0)
    # a reshape that cannot be a view copies: read and write 24 elements
    m = _count(lambda x: x.view(6, 4).t().reshape(24), x)
    assert (m.total.flops, m.total.bytes) == (0.0, 2 * (24 + 24))
    m = _count(lambda x: (x * 2.0).sum(), x)
    # mul: 24 elements read and written (bf16); sum: 24 read, 1 written
    assert m.total.flops == 24 + 24
    assert m.total.bytes == 2 * (24 + 24) + 2 * (24 + 1)


def test_indexed_write_costs_twice_its_rows():
    cache, row = torch.zeros(4, 1000, 8), torch.ones(4, 1, 8)
    at = torch.tensor([7])
    m = _count(lambda c, r, i: c.index_copy_(1, i, r), cache, row, at)
    assert m.total.bytes == 2 * (4 * 8 * 4 + 8)   # the row and the index


def test_kernel_stand_in_is_counted_once():
    from repro_torch.kernels.flash_attention import ops as fa
    q = torch.ones(1, 8, 2, 4)
    fa.reset_launches()
    m = _count(lambda q, k, v: fa.flash_attention_auto(q, k, v), q, q, q)
    assert m.kernels == {"flash_attention": 1}
    assert fa.LAUNCHES == {"flash_attention": 0}
    # causal over 8 positions: 36 pairs, 4 * D FLOPs a pair and head
    assert m.total.flops == 4.0 * 1 * 2 * 4 * 36
    assert m.total.bytes == 4 * 4 * q.numel()


@pytest.mark.parametrize("sq,skv,causal,window,want", [
    (8, 8, True, None, 36), (8, 8, True, 3, 1 + 2 + 3 * 6),
    (4, 8, True, None, 5 + 6 + 7 + 8), (3, 5, False, None, 15)])
def test_attended_pairs(sq, skv, causal, window, want):
    from repro_torch.kernels.flash_attention import ops as fa
    assert fa.attended_pairs(sq, skv, causal, window) == want


def _run_sub(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def test_all_reduce_on_a_fake_mesh_counts_its_bytes():
    """A (64, 32) fp32 product sharded on its contracted dim over
    ``model`` (2 of a fake 2 x 2 x 2 mesh) is Partial; making it
    Replicate is one all-reduce of the local (64, 32) fp32 = 8 KiB on the
    model group, priced at NVLink (the 8 ranks share a node). And the
    links of a (16, 16) mesh are the network's."""
    out = _run_sub("""
        import torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch.mesh import init_fake_world
        from repro_torch.roofline import analysis
        from repro_torch.roofline.cost import CostMode
        from torch.distributed.device_mesh import init_device_mesh
        init_fake_world(8)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        links = analysis.group_links(mesh)
        assert set(links.values()) == {analysis.NVLINK_BW}, links
        mode = CostMode(links=links, default_link=analysis.NETWORK_BW)
        R = Replicate()
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(64, 8), mesh, [R, R, Shard(1)],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(8, 32), mesh, [R, R, Shard(0)],
                                   run_check=False)
            with mode:
                y = (x @ w).redistribute(mesh, [R, R, R])
        assert y.to_local().shape == (64, 32)
        assert mode.total.coll == {"all_reduce": 64 * 32 * 4}, mode.total.coll
        assert mode.total.flops == 2 * 64 * 8 * 32, mode.total.flops
        assert abs(mode.total.coll_s - 64 * 32 * 4 / analysis.NVLINK_BW) < 1e-15
        assert mode.global_flops == 2 * 64 * 16 * 32, mode.global_flops
        init_fake_world(256)
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        assert set(analysis.group_links(mesh).values()) == {
            analysis.NETWORK_BW}
        print("COLL_OK")
    """)
    assert "COLL_OK" in out
