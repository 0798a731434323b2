"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each ``csrc/<name>.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/<name>-<hash of the source>.so`` under the checkout
(``.gitignore`` lists ``build/``), at first use, and is loaded with
``ctypes``. The hash covers the source and every local header it
includes (``#include "..."``, followed recursively), so an edit to either
changes the path and a stale library is never loaded. ``build_all``
starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

SOURCES: Dict[str, Path] = {
    "greedy_round": KERNELS_DIR / "pairwise" / "csrc" / "greedy_round.cu",
    "gated_greedy_round":
        KERNELS_DIR / "pairwise" / "csrc" / "gated_greedy_round.cu",
    "pairwise_min_argmin":
        KERNELS_DIR / "pairwise" / "csrc" / "pairwise_min_argmin.cu",
    "flash_attention":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bf16":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_bf16.cu",
    "uncertainty_stats":
        KERNELS_DIR / "uncertainty" / "csrc" / "uncertainty_stats.cu",
    "decode_attention":
        KERNELS_DIR / "decode_attention" / "csrc" / "decode_attention.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _hashed_files(source: Path) -> list:
    """``source`` and the local headers it includes, recursively, each
    resolved against the including file's directory."""
    seen, todo = [], [source.resolve()]
    while todo:
        f = todo.pop()
        if f in seen or not f.exists():
            continue
        seen.append(f)
        for inc in _LOCAL_INCLUDE.findall(f.read_bytes()):
            todo.append((f.parent / inc.decode()).resolve())
    return seen


def source_hash(name: str) -> str:
    """12 hex digits of the hash over ``name``'s source and its local
    headers: it changes with any edit to either."""
    h = hashlib.sha1()
    for f in _hashed_files(SOURCES[name]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)     # atomic publish: a reader never sees half a .so
    return log


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once.
    Returns each build's compiler log (ptxas register and shared-memory
    report; empty for a library that was already built)."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
