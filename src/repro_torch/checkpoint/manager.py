# Port of repro/checkpoint/manager.py (without elastic restore).
"""Atomic, async checkpointing in the reference's on-disk format.

Layout per step:  <dir>/step_<n:012d>/
    manifest.msgpack   {"step", "entries": [{"path", "file", "dtype",
                       "shape"}], "metadata", "complete": True}
    arr_<i>.bin[.zst]  one file per leaf: its raw bytes in C order

A leaf's ``path`` joins its keys and indices with ``/`` in jax's leaf
order (``common.tree``), and ``dtype`` is numpy's name (``float32``,
``bfloat16``, ``int32``, ...), so either package's manager reads the
other's files. A bf16 leaf is written and read as raw bytes
(``torch.frombuffer``), with no ``ml_dtypes``. ``zstandard`` is
optional, as in the reference.

Guarantees:
  * atomic: written to a tmp dir, fsynced, then renamed; a crash mid-save
    never corrupts the latest checkpoint (restore scans for complete
    dirs).
  * async: ``save_async`` copies the tree to host memory synchronously
    and writes it on a background thread, so the train loop only blocks
    for the device -> host copy.

Restore onto another device count (the reference's elastic restore)
waits for ROADMAP A13's tooling slice; ``restore`` puts each leaf on its
template leaf's device.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.common.tree import leaves_with_paths, tree_unflatten

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover
    zstd = None

_DTYPES = {str(d).split(".")[1]: d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool,
    torch.float8_e4m3fn, torch.float8_e5m2)}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


def _host(x, copy: bool = False) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (a number or a numpy array in
    numpy's dtype, as the reference writes it); ``copy`` always copies."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x))
    return x.detach().to("cpu", copy=copy).contiguous()


def _leaf_paths(tree):
    flat = leaves_with_paths(tree)
    return [p for p, _ in flat], [leaf for _, leaf in flat]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, compress: bool = False):
        self.dir = directory
        self.keep = keep
        self.compress = compress and zstd is not None
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------- save ----
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        paths, leaves = _leaf_paths(tree)
        self._write(step, paths, [_host(x) for x in leaves], metadata or {})

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None):
        self.wait()
        paths, leaves = _leaf_paths(tree)
        host = [_host(x, copy=True) for x in leaves]          # sync copy

        def work():
            try:
                self._write(step, paths, host, metadata or {})
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, paths, leaves, metadata: dict):
        final = os.path.join(self.dir, f"step_{step:012d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        for i, (p, t) in enumerate(zip(paths, leaves)):
            fname = f"arr_{i}.bin" + (".zst" if self.compress else "")
            blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            if self.compress:
                blob = zstd.ZstdCompressor(level=3).compress(blob)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(blob)
            entries.append({"path": p, "file": fname,
                            "dtype": _dtype_name(t),
                            "shape": list(t.shape)})
        manifest = {"step": step, "entries": entries, "metadata": metadata,
                    "complete": True}
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(msgpack.packb(manifest))
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # -------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if not os.path.exists(os.path.join(self.dir, name,
                                               "manifest.msgpack")):
                continue
            out.append(int(name[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple:
        """Returns (tree, step, metadata). ``template`` fixes the tree's
        structure; each leaf comes back in the dtype and shape the file
        names, on the template leaf's device where that is a tensor, else
        on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
            manifest = msgpack.unpackb(f.read(), raw=False)
        by_path = {e["path"]: e for e in manifest["entries"]}
        paths, leaves = _leaf_paths(template)
        out = []
        for p, tmpl in zip(paths, leaves):
            e = by_path[p]
            with open(os.path.join(d, e["file"]), "rb") as f:
                blob = f.read()
            if e["file"].endswith(".zst"):
                blob = zstd.ZstdDecompressor().decompress(blob)
            dtype = _DTYPES[e["dtype"]]
            t = (torch.frombuffer(bytearray(blob), dtype=dtype) if blob
                 else torch.empty((0,), dtype=dtype)).reshape(e["shape"])
            dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            out.append(t.to(dev))
        return tree_unflatten(template, out), manifest["step"], \
            manifest["metadata"]
