"""Port parity: the logical-axis rules (``distributed/partition.py``),
``distributed/elastic.py`` and the checkpoint manager's elastic restore
against the reference's.

(a) ``AxisRules.pspec`` equals the reference's on the reference's own
    cases (``tests/test_distributed.py``), and on every parameter and
    cache leaf of the ten archs' full configs at both production meshes,
    (16, 16) and (2, 16, 16), with the stacked ``layer`` axis dropped
    (the port keeps a list of units for the weights and a leading
    ``count`` axis on every cache leaf, the reference a ``layer`` axis
    where a segment stacks more than one unit). The reference's
    ``make_rules`` takes a stub with ``axis_names`` and
    ``devices.shape``, so no 512 devices are needed.
(b) ``placements``: a dim mapped to ("pod", "data") shards on both.
(c) ``largest_mesh_shape`` equals the reference's for n <= 64 and
    model_parallel <= 16, errors included.
(d) A checkpoint written at world 1 restores under a (2, 2) mesh on 4
    gloo ranks (``restore(..., placements=)``), each rank slicing its
    shard, and the gathered tensors equal the written ones bit for bit.
(e) ``moe_apply`` on DTensors (the dry run's path: each rank routes its
    tokens and dispatches to its own experts) against the plain call on
    the same fp32 inputs: on a (1, 1, 1) mesh of one gloo rank, bit for
    bit; on (1, 2, 2) over 4 ranks (batch over data, the 8 experts over
    model, each rank's combine a partial sum), out and aux within 1e-6
    of the largest |value| (the fp32 partials add in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.param import ParamDecl
from repro_torch.common.tree import leaves_with_paths, tree_map
from repro_torch.distributed import elastic, partition
from repro_torch.models.transformer import Model

ARCHS = ["qwen3-8b", "internlm2-20b", "phi3-medium-14b", "qwen1.5-4b",
         "deepseek-moe-16b", "deepseek-v3-671b", "rwkv6-3b",
         "recurrentgemma-2b", "whisper-medium", "llava-next-34b"]
MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
# the cache at a decode cell's batch and length
CACHE_B, CACHE_S = 128, 32768


class _RefMesh:
    """The reference's make_rules reads axis_names and devices.shape."""
    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.zeros(shape)


class _PortMesh:
    def __init__(self, axes, shape):
        self.mesh_dim_names = axes
        self.shape = shape


def _rules(axes=("data", "model"), shape=(16, 16)):
    return partition.make_rules(_PortMesh(axes, shape))


@pytest.mark.parametrize("mesh", [*MESHES, "data2x2", "model_only"])
def test_batch_size_matches_reference(mesh):
    """``AxisRules.batch_size``: the product of the mesh sizes of the batch
    axes, equal to the reference's on the production meshes and on meshes
    that hold some or none of them."""
    pytest.importorskip("jax")
    from repro.distributed import partition as ref_partition
    axes, shape = {**MESHES, "data2x2": (("data", "model"), (2, 2)),
                   "model_only": (("model",), (4,))}[mesh]
    rules = partition.make_rules(_PortMesh(axes, shape))
    want = ref_partition.make_rules(_RefMesh(axes, shape)).batch_size()
    assert rules.batch_size() == want
    assert want == int(np.prod([dict(zip(axes, shape))[a]
                                for a in rules.batch_axes()]))


def test_pspec_basic():
    assert _rules().pspec(("embed", "ff"), (256, 1024)) == ("data", "model")


def test_pspec_divisibility_relaxation():
    r = _rules()
    # 40 heads do not divide 16 -> replicate that dim
    assert r.pspec(("heads", None), (40, 128)) == ()
    # flat fused dim divides -> sharded
    assert r.pspec(("batch", None, "qkv"), (256, 4, 5120)) == \
        ("data", None, "model")


def test_pspec_no_axis_reuse():
    # expert takes "model" first; ff must not reuse it
    assert _rules().pspec(("expert", "embed", "ff"), (64, 2048, 1408)) == \
        ("model", "data")


def test_pspec_multipod_batch():
    r = _rules(("pod", "data", "model"), (2, 16, 16))
    assert r.pspec(("batch", None), (256, 4096)) == (("pod", "data"),)
    assert r.pspec(("batch", None), (1, 4096)) == ()


def test_tree_pspecs():
    specs = partition.tree_pspecs(
        {"w": ParamDecl((512, 1024), ("embed", "ff"))}, _rules())
    assert specs["w"] == ("data", "model")


def test_placements_shard_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard
    r = _rules(("pod", "data", "model"), (2, 16, 16))
    assert r.placements(("batch", None, "qkv"), (256, 4, 1024)) == \
        (Shard(0), Shard(0), Shard(2))
    assert r.placements(("heads",), (40,)) == (Replicate(),) * 3


def test_param_decl_length_check():
    with pytest.raises(ValueError, match="differ in length"):
        ParamDecl((4, 8), ("embed",))
    assert ParamDecl((4, 8)).logical == (None, None)


def _ref_leaves(decls):
    import jax
    from repro.common.param import is_decl
    flat, _ = jax.tree_util.tree_flatten_with_path(decls, is_leaf=is_decl)
    out = {}
    for path, d in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = d
    return out


def _strip(spec: tuple) -> tuple:
    """A pspec with its leading (layer) entry dropped."""
    return tuple(spec[1:])


def _port_param_key(path: str) -> str:
    """segments/si/li/... -> segments/si/...; encoder/segment/li/... ->
    encoder/segment/...: the reference's key of a port leaf."""
    parts = path.split("/")
    if parts[0] == "segments":
        return "/".join(parts[:2] + parts[3:])
    if parts[:2] == ["encoder", "segment"]:
        return "/".join(parts[:2] + parts[3:])
    return path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_match_reference_on_every_leaf(arch, mesh):
    """Every parameter and cache leaf's pspec equals the reference's."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.distributed import partition as ref_partition
    from repro.models.transformer import Model as RefModel
    axes, shape = MESHES[mesh]
    rules = partition.make_rules(_PortMesh(axes, shape))
    ref_rules = ref_partition.make_rules(_RefMesh(axes, shape))
    model, ref_model = Model(configs.get_config(arch)), RefModel(
        ref_config(arch))

    def ref_spec(d):
        spec = tuple(ref_rules.pspec(d.logical, d.shape))
        return _strip(spec) if d.logical[:1] == ("layer",) else spec

    ref_params = _ref_leaves(ref_model.param_decls())
    ours = leaves_with_paths(model.param_decls())
    seen = set()
    for path, d in ours:
        key = _port_param_key(path)
        seen.add(key)
        assert rules.pspec(d.logical, d.shape) == ref_spec(ref_params[key]), \
            path
    assert seen == set(ref_params)

    ref_cache = _ref_leaves(ref_model.cache_decls(CACHE_B, CACHE_S))
    ours = leaves_with_paths(model.cache_decls(CACHE_B, CACHE_S))
    # an enc-dec cache's enc_len (a replicated scalar) is the port's own
    extra = {p for p, _ in ours} - set(ref_cache)
    assert extra == ({"enc_len"} if model.cfg.enc_dec else set())
    assert set(ref_cache) <= {p for p, _ in ours}
    for path, d in ours:
        spec = rules.pspec(d.logical, d.shape)
        if path in extra:
            assert spec == ()
            continue
        if d.logical[:1] == ("layer",):
            spec = _strip(spec)
        assert spec == ref_spec(ref_cache[path]), path


@pytest.mark.parametrize("n", range(1, 65))
def test_largest_mesh_shape_matches_reference(n):
    pytest.importorskip("jax")
    from repro.distributed import elastic as ref_elastic
    for mp in range(1, 17):
        assert elastic.largest_mesh_shape(n, mp) == \
            ref_elastic.largest_mesh_shape(n, mp)


@pytest.mark.parametrize("n,mp", [(0, 1), (-3, 1), (8, 0), (8, -2)])
def test_largest_mesh_shape_errors_match_reference(n, mp):
    pytest.importorskip("jax")
    from repro.distributed import elastic as ref_elastic
    with pytest.raises(ValueError) as ours:
        elastic.largest_mesh_shape(n, mp)
    with pytest.raises(ValueError) as theirs:
        ref_elastic.largest_mesh_shape(n, mp)
    assert str(ours.value) == str(theirs.value)


def _restore_rank(rank, world, group, device, directory, decls):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.tree import tree_leaves
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                          "model"))
    pl, _ = elastic.reshard_plan(decls, mesh)
    template = {k: DTensor.from_local(torch.zeros(1), mesh,
                                      [torch.distributed.tensor.Replicate()]
                                      * 2, run_check=False)
                for k in decls}
    tree, step, _ = CheckpointManager(directory).restore(
        template, placements=pl)
    out = {}
    for k, t in tree.items():
        assert tuple(t.placements) == tuple(pl[k]), k
        out[k] = (t.to_local().clone(), t.full_tensor().clone())
    return step, out


def test_checkpoint_restores_onto_a_2x2_mesh(tmp_path):
    """Written at world 1, restored onto (data 2, model 2) over 4 gloo
    ranks: each rank holds its slice, and the gathered leaves are the
    written bytes."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import run_debug_mesh
    decls = {"w": ParamDecl((8, 6), ("embed", "ff")),
             "e": ParamDecl((4, 3, 10), ("expert", "embed", None)),
             "b": ParamDecl((5,), ("norm",))}
    g = torch.Generator().manual_seed(3)
    tree = {k: torch.randn(d.shape, generator=g) for k, d in decls.items()}
    tree["w"] = tree["w"].bfloat16()
    CheckpointManager(str(tmp_path)).save(7, tree)
    results = run_debug_mesh(_restore_rank, 4, str(tmp_path), decls,
                             backend="gloo", device="cpu")
    for rank, (step, out) in enumerate(results):
        assert step == 7
        d, m = divmod(rank, 2)
        for k, (local, full) in out.items():
            assert full.dtype == tree[k].dtype
            assert torch.equal(full, tree[k]), (rank, k)
        assert torch.equal(out["w"][0], tree["w"][d * 4:(d + 1) * 4,
                                                 m * 3:(m + 1) * 3])
        assert torch.equal(out["e"][0], tree["e"][m * 2:(m + 1) * 2])
        assert torch.equal(out["b"][0], tree["b"])


MOE_FIELDS = dict(n_routed=8, top_k=2, d_ff_expert=16, n_shared=1,
                  group_size=32, capacity_factor=1.5)
MOE_D, MOE_B, MOE_S = 24, 2, 32


def _moe_inputs():
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.layers import moe
    mo = MoEConfig(**MOE_FIELDS)
    decls = moe.moe_decls(MOE_D, mo)
    rng = np.random.default_rng(5)
    params = tree_map(
        lambda d: torch.from_numpy(
            (rng.standard_normal(d.shape) * 0.2).astype(np.float32)), decls)
    x = torch.from_numpy(rng.standard_normal(
        (MOE_B, MOE_S, MOE_D)).astype(np.float32))
    return mo, decls, params, x


def _moe_rank(rank, world, group, device, shape):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.layers import moe
    mo, decls, params, x = _moe_inputs()
    mesh = init_device_mesh("cpu", shape,
                            mesh_dim_names=("pod", "data", "model"))
    rules = partition.make_rules(mesh)
    pl = partition.tree_placements(decls, rules)
    dparams = tree_map(
        lambda t, p: partition.shard_of(t, mesh, p), params, pl)
    dx = partition.shard_of(x, mesh, rules.placements(("batch", None, None),
                                                      x.shape))
    with partition.activation_rules(rules):
        out, aux = moe.moe_apply(dparams, dx, mo)
    return out.full_tensor(), aux.full_tensor()


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 2)])
def test_moe_on_dtensors_matches_plain(shape):
    from repro_torch.launch.mesh import run_debug_mesh
    from repro_torch.models.layers import moe
    mo, _, params, x = _moe_inputs()
    want, want_aux = moe.moe_apply(params, x, mo)
    world = int(np.prod(shape))
    for out, aux in run_debug_mesh(_moe_rank, world, shape, backend="gloo",
                                   device="cpu"):
        if world == 1:
            assert torch.equal(out, want) and torch.equal(aux, want_aux)
        else:
            tol = 1e-6 * float(want.abs().max())
            assert float((out - want).abs().max()) <= tol
            assert abs(float(aux - want_aux)) <= 1e-6 * abs(float(want_aux))
