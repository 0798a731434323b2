"""The port stands alone: repro_torch and chip_smoke.py import neither JAX
nor anything of the repro package, the package imports and serves a CPU
query with JAX made unimportable, and entry points default to the GPU
(raising where there is none) unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.service.config import ALServiceConfig
from repro_torch.service.server import ALServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_every_port_module():
    names = {p.name for p in PORT_FILES}
    assert {"server.py", "ops.py", "diversity.py", "resnet.py",
            "chip_smoke.py"} <= names
    assert _forbidden("jax.numpy") and _forbidden("repro.core")
    assert not _forbidden("repro_torch.core")


def test_package_serves_a_cpu_query_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        from repro_torch.data.synthetic import image_pool
        from repro_torch.service.config import ALServiceConfig
        from repro_torch.service.server import ALServer
        srv = ALServer(ALServiceConfig(device="cpu", batch_size=8))
        xs, _ = image_pool(40, seed=1)
        srv.push_data(list(xs))
        for s in ("lc", "kcg", "dbal"):
            assert len(srv.query(budget=4, strategy=s)["keys"]) == 4
        assert not any(m == "repro" or m.startswith(("repro.", "jax."))
                       for m in sys.modules)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_device_defaults_to_cuda_and_cpu_is_explicit():
    assert ALServiceConfig().device == "cuda"
    assert ALServiceConfig.from_yaml("name: X\n").device == "cuda"
    cfg = ALServiceConfig.from_yaml(
        "active_learning:\n  device: CPU\n")
    assert cfg.device == "CPU"
    assert str(ALServer(cfg).device) == "cpu"


def test_cuda_server_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda server starts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALServer(ALServiceConfig(device="cuda", model_name="synthetic_cnn"))
