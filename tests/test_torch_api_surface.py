"""The port does all that ``repro`` does, name for name.

An AST walk over both source trees (it imports neither package, so it
runs without JAX): every public top-level ``def``/``class`` and every
public method of a public class in ``src/repro/**.py`` has a twin of the
same name in the same module under ``src/repro_torch/``, or an entry in
COUNTERPARTS. An entry names the reference name (``module:name``, a
method as ``Class.method``, a whole module as ``module:*``), the port's
counterpart as ``module:name``, which must exist, and why they differ.
Those differences are JAX mechanics: the TPU probe, ``shard_map``, device
meshes and shardings, shape structs for lowering, HLO text, the Pallas
kernel modules and the functional ResNet. Private names of the reference
are listed where the port does their work under another name.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"

COUNTERPARTS = {
    # the TPU probe: the port dispatches on the tensor's device
    "kernels/pairwise/ops.py:_on_tpu": (
        "kernels/pairwise/ops.py:_use_kernel",
        "dispatch follows the tensor's device, not the backend"),
    "kernels/uncertainty/ops.py:_on_tpu": (
        "kernels/uncertainty/ops.py:_use_kernel",
        "dispatch follows the tensor's device, not the backend"),
    "kernels/flash_attention/ops.py:_on_tpu": (
        "kernels/flash_attention/ops.py:flash_attention_auto",
        "the wrapper dispatches on the tensor's device"),
    "kernels/decode_attention/ops.py:_on_tpu": (
        "kernels/decode_attention/ops.py:decode_attention_auto",
        "the wrapper dispatches on the tensor's device"),
    "kernels/pairwise/autotune.py:_on_tpu": (
        "kernels/pairwise/autotune.py:autotune_blocks",
        "the picker measures when it is handed a CUDA device"),
    # jit's split: eager torch runs the round in the public function
    "kernels/pairwise/ops.py:_greedy_round_unfused": (
        "kernels/pairwise/ops.py:greedy_round_unfused",
        "the reference splits the ops out to jit them"),
    # meshes, shardings and collectives
    "core/selection.py:shard_map": (
        "core/selection.py:_all_gather",
        "shards are ranks of a torch.distributed group; no shard_map"),
    "launch/mesh.py:make_debug_mesh": (
        "launch/mesh.py:run_debug_mesh",
        "a debug mesh is spawned ranks, not forced host devices"),
    "launch/mesh.py:set_mesh": (
        "launch/mesh.py:run_debug_mesh",
        "no global mesh context: each rank gets its group"),
    "distributed/partition.py:tree_shardings": (
        "distributed/partition.py:tree_placements",
        "DTensor placements stand for NamedShardings"),
    # shape structs and lowering: the port traces under FakeTensorMode
    "common/param.py:ParamDecl.sds": (
        "launch/steps.py:Cell.fake_args",
        "fake tensors stand for jax.ShapeDtypeStruct"),
    "common/param.py:param_shapes": (
        "launch/steps.py:Cell.fake_args",
        "fake tensors stand for jax.ShapeDtypeStruct"),
    "models/transformer.py:Model.param_sds": (
        "launch/steps.py:Cell.fake_args",
        "fake tensors stand for jax.ShapeDtypeStruct"),
    "launch/steps.py:Cell.lower": (
        "launch/steps.py:Cell.trace",
        "a FakeTensorMode trace stands for XLA lowering"),
    # HLO text: the port counts a traced step's ops
    "roofline/attribution.py:Attribution": (
        "roofline/attribution.py:top_costs",
        "costs by source come from the trace, not HLO metadata"),
    "roofline/analysis.py:collective_bytes": (
        "roofline/cost.py:CostMode",
        "collectives are counted at dispatch, not read from HLO text"),
    "roofline/analysis.py:shape_bytes": (
        "roofline/cost.py:CostMode",
        "bytes come from the tensors, not HLO type strings"),
    # the functional ResNet is an nn.Module
    "models/resnet.py:init_resnet": (
        "models/resnet.py:ResNet",
        "the module's constructor draws the weights"),
    "models/resnet.py:resnet_decls": (
        "models/resnet.py:ResNet",
        "the module's parameters are its declarations"),
    "models/resnet.py:resnet_features": (
        "models/resnet.py:ResNet.forward",
        "the module's forward is the feature trunk"),
    "models/resnet.py:resnet_logits": (
        "service/backends.py:FeatureBackend.probs",
        "the trunk holds no head; the service's softmax head scores it"),
    # the JAX-only modules
    "kernels/compat.py:*": (
        "kernels/build.py:build_all",
        "a shim between Pallas versions; nvcc builds stand there"),
    "kernels/pairwise/kernel.py:*": (
        "kernels/pairwise/ops.py:_lib",
        "Pallas kernels; the CUDA sources in csrc/ are bound here"),
    "kernels/flash_attention/kernel.py:*": (
        "kernels/flash_attention/ops.py:_lib",
        "Pallas kernel; the CUDA sources in csrc/ are bound here"),
    "kernels/decode_attention/kernel.py:*": (
        "kernels/decode_attention/ops.py:_lib",
        "Pallas kernel; the CUDA source in csrc/ is bound here"),
    "kernels/uncertainty/kernel.py:*": (
        "kernels/uncertainty/ops.py:_lib",
        "Pallas kernel; the CUDA source in csrc/ is bound here"),
    "roofline/hlo_analyzer.py:*": (
        "roofline/cost.py:CostMode",
        "an HLO text parser; the port counts a traced step's ops"),
}

# The names the port gained last, each with a same-named twin.
LAST_ADDED = [
    "kernels/pairwise/ops.py:greedy_round_unfused",
    "kernels/pairwise/ops.py:op_stats",
    "kernels/pairwise/ops.py:pairwise_min_dist",
    "kernels/pairwise/ref.py:pairwise_min_dist_ref",
    "kernels/pairwise/ref.py:pairwise_argmin_ref",
    "service/server.py:ALServer.shard_executor",
    "distributed/partition.py:AxisRules.batch_size",
]
EXAMPLES = ["quickstart.py", "al_image_service.py", "al_train_loop.py",
            "distributed_selection.py"]

_PARSED = {}


def _module(path: pathlib.Path):
    """{top-level name: None, or {method names} for a class} of a file."""
    if path not in _PARSED:
        out = {}
        for node in ast.parse(path.read_text(), str(path)).body:
            if isinstance(node, ast.ClassDef):
                out[node.name] = {
                    m.name for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                } | {t.id for m in node.body if isinstance(m, ast.Assign)
                     for t in m.targets if isinstance(t, ast.Name)}
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[node.name] = None
            elif isinstance(node, ast.Assign):
                out.update({t.id: None for t in node.targets
                            if isinstance(t, ast.Name)})
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                out.update({(a.asname or a.name).split(".")[0]: None
                            for a in node.names})
        _PARSED[path] = out
    return _PARSED[path]


def _has(root: pathlib.Path, ref: str) -> bool:
    """Whether ``module:name`` (``Class.method`` or ``*``) exists under
    ``root``."""
    rel, name = ref.split(":")
    path = root / rel
    if not path.is_file():
        return False
    if name == "*":
        return True
    names = _module(path)
    owner, _, method = name.partition(".")
    if owner not in names:
        return False
    return not method or method in (names[owner] or ())


def _reference_names():
    """Every public top-level def/class and public method of a public
    class of the reference, as ``module:name``; a whole module where the
    port has no file of that name."""
    out = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        if not (PORT / rel).is_file():
            out.append(f"{rel}:*")
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)) or \
                    node.name.startswith("_"):
                continue
            out.append(f"{rel}:{node.name}")
            if isinstance(node, ast.ClassDef):
                out.extend(f"{rel}:{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
    return out


REFERENCE_NAMES = _reference_names()


def test_the_walk_sees_both_trees():
    assert len(REFERENCE_NAMES) > 400
    for name in ("service/server.py:ALServer.query",
                 "kernels/pairwise/ops.py:greedy_round",
                 "models/transformer.py:Model.loss",
                 "kernels/pairwise/kernel.py:*"):
        assert name in REFERENCE_NAMES, name
    assert _has(PORT, "service/server.py:ALServer.query")
    assert not _has(PORT, "service/server.py:ALServer.no_such_method")
    assert not _has(PORT, "kernels/pairwise/kernel.py:*")


def test_every_reference_name_has_a_twin_or_a_counterpart():
    missing = [n for n in REFERENCE_NAMES if not _has(PORT, n)
               and n not in COUNTERPARTS
               # a method of a class listed whole
               and n.rpartition(".")[0] not in COUNTERPARTS]
    assert not missing, ("no same-named twin under src/repro_torch/ and no "
                         f"COUNTERPARTS entry: {missing}")


@pytest.mark.parametrize("name", sorted(COUNTERPARTS))
def test_each_counterpart_exists_and_is_needed(name):
    """The reference name exists, has no same-named twin (else the entry
    is not needed), and its counterpart exists in the port."""
    port, why = COUNTERPARTS[name]
    assert _has(REF, name), name
    assert not _has(PORT, name), f"{name} has a same-named twin"
    assert _has(PORT, port), port
    assert why


@pytest.mark.parametrize("name", LAST_ADDED)
def test_last_added_names_have_same_named_twins(name):
    assert _has(REF, name) and _has(PORT, name), name


@pytest.mark.parametrize("example", EXAMPLES)
def test_every_reference_example_has_a_twin(example):
    ref = ROOT.parent / "examples" / example
    port = PORT / "examples" / example
    assert ref.is_file() and port.is_file()
    assert port.read_text().startswith(f"# Port of examples/{example}.")
    assert "main" in _module(port) and "main" in _module(ref)
