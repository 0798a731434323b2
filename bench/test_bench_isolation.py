"""The benchmark stands apart: nothing under ``bench/`` imports JAX, flax
or the JAX package (``repro``; compared by whole top-level names, since
``repro_torch`` begins with it), the plain reference imports nothing of
the port, the test files' names are not those of ``tests/``, and a toy
run loads none of those modules with JAX made unimportable."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

from bench import harness, testing

ROOT = testing.ROOT
BENCH_FILES = sorted((ROOT / "bench").rglob("*.py"))
# the toy architecture's reference becomes bench/reference/toy_mla.py in
# the copies of the layout the tests make
REFERENCE_FILES = sorted((ROOT / "bench" / "reference").rglob("*.py")) + [
    ROOT / "bench" / "toy_mla" / "reference.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [m for m in _imports(path)
           if _top(m) in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", REFERENCE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_port(path):
    allowed = {"__future__", "contextlib", "math", "torch", "bench"}
    mods = list(_imports(path))
    assert all(_top(m) in allowed for m in mods), mods
    assert all(m.startswith("bench.reference") for m in mods
               if _top(m) == "bench"), mods


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax"]) \
        == ["flax", "jax", "repro"]
    assert harness.forbidden_modules(["repro_torch.models", "jaxtyping",
                                      "bench.harness"]) == []


def test_test_file_names_are_not_those_of_tests():
    ours = {p.name for p in (ROOT / "bench").rglob("test_*.py")}
    theirs = {p.name for p in (ROOT / "tests").rglob("test_*.py")}
    assert ours and not ours & theirs


def test_toy_run_loads_no_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        from pathlib import Path
        sys.modules["jax"] = None          # any import of jax now fails
        from bench import harness, testing
        root = testing.copy_layout(Path(sys.argv[1]))
        cell = testing.add_toy_cell(root, "deepseek-moe-16b")
        r = harness.run(harness.Layout(root), cell, 3, 0.2, False,
                        device="cpu")
        assert r.attempted > 0
        print(harness.forbidden_modules(
            [m for m in sys.modules if sys.modules[m] is not None]))
    """)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
