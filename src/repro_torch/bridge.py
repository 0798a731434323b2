"""Weight bridge: load ``repro``'s parameters, given as numpy arrays, into
the port's modules.

The port draws its own random weights from ``torch.Generator``s, which
cannot reproduce ``jax.random``. Parity with the reference therefore needs
the reference's exact weights; this module carries them over. It takes
numpy arrays only, so it needs nothing of the reference package:

* ``load_resnet``: an ``init_resnet`` tree (``{"stem": HWIO, "blocks":
  [{"conv1", "conv2", "scale1", "scale2", ["proj"]}, ...]}``), convolutions
  HWIO -> OIHW. The tree's ``head`` is not part of the feature trunk and is
  ignored, as the reference's features ignore it.
* ``load_mlp``: an MLP backend's ``w1``/``w2``.
* ``load_encoder``: an ``init_encoder`` tree into a TransformerBackend,
  its stacked layer axis unstacked.
* ``load_model``: a ``Model.init`` tree of the dense, MoE (with or
  without MLA), RWKV, Griffin, enc-dec or patch-prefix LM into the port's
  ``models.transformer`` tree, every dtype kept (bf16 stays bf16, the MoE
  router fp32), the encoder's stacked layers unstacked too.
* ``head_state`` / ``set_initial_head``: a softmax head (trained, or the
  reference's ``init_head()`` that every fit starts from).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.transformer import model_decls
from repro_torch.service.backends import FeatureBackend, HeadState


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _conv(w_hwio, device) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1)), device)


def load_resnet(model: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Copy an ``init_resnet`` parameter tree into a port ``ResNet``."""
    dev = model.stem.device
    with torch.no_grad():
        model.stem.copy_(_conv(params["stem"], dev))
        if len(params["blocks"]) != len(model.blocks):
            raise ValueError(f"{len(params['blocks'])} blocks for a model "
                             f"of {len(model.blocks)}")
        for b, p in zip(model.blocks, params["blocks"]):
            b.conv1.copy_(_conv(p["conv1"], dev))
            b.conv2.copy_(_conv(p["conv2"], dev))
            b.scale1.copy_(_t(p["scale1"], dev))
            b.scale2.copy_(_t(p["scale2"], dev))
            if ("proj" in p) != hasattr(b, "proj"):
                raise ValueError("projection layout differs")
            if "proj" in p:
                b.proj.copy_(_conv(p["proj"], dev))


def load_mlp(backend, w1, w2) -> None:
    backend.w1 = _t(w1, backend.device)
    backend.w2 = _t(w2, backend.device)


def head_state(w, b, device="cpu") -> HeadState:
    return HeadState(w=_t(w, device), b=_t(b, device))


def set_initial_head(backend: FeatureBackend, w, b) -> None:
    """Make every ``fit_head`` of ``backend`` start from this head."""
    backend.initial_head = head_state(w, b, backend.device)


def load_encoder(backend, params: Mapping[str, Any]) -> None:
    """Copy a reference ``init_encoder`` tree into a port
    ``TransformerBackend``'s encoder. The tree's ``layers`` carry a leading
    layer axis (stacked ``(n_layers, ...)`` leaves), unstacked here; the
    other keys (``embed`` or ``frame_proj``, ``final_norm``) copy as they
    are. Every leaf of either side must have its counterpart."""
    port = backend.encoder.params
    dev = backend.device
    n_layers = len(port["layers"])

    def copy(dst, src, path):
        if set(dst) != set(src):
            raise ValueError(f"{path}: port keys {sorted(dst)} differ from "
                             f"reference keys {sorted(src)}")
        for key, val in src.items():
            if isinstance(dst[key], torch.Tensor):
                arr = np.asarray(val, np.float32)
                if arr.shape != tuple(dst[key].shape):
                    raise ValueError(f"{path}/{key}: shape {arr.shape}, "
                                     f"port has {tuple(dst[key].shape)}")
                with torch.no_grad():
                    dst[key].copy_(_t(arr, dev))
            else:
                copy(dst[key], val, f"{path}/{key}")

    def layer(tree, i):
        return {k: (layer(v, i) if isinstance(v, Mapping)
                    else np.asarray(v)[i]) for k, v in tree.items()}

    stacked = params["layers"]
    some = stacked["norm1"]["scale"]
    if np.asarray(some).shape[0] != n_layers:
        raise ValueError(f"{np.asarray(some).shape[0]} layers for an "
                         f"encoder of {n_layers}")
    for i in range(n_layers):
        copy(port["layers"][i], layer(stacked, i), f"layers[{i}]")
    copy({k: v for k, v in port.items() if k != "layers"},
         {k: v for k, v in params.items() if k != "layers"}, "")


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype on ``device``;
    a bfloat16 array (numpy's ``ml_dtypes`` extension type) is carried
    over bit for bit."""
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _unstack(seg, tree):
    """A reference segment (``{"0": layer, ...}``; every leaf stacked on
    a leading layer axis where the segment repeats its unit more than
    once) as the port's list of units."""
    scale = np.asarray(seg["0"]["norm1"]["scale"])
    if scale.ndim == 1:
        return [tree(seg, lambda a: a)]
    return [tree(seg, lambda a, i=i: a[i]) for i in range(scale.shape[0])]


def load_model(params: Mapping[str, Any], cfg, device="cpu"):
    """The port's parameter tree for a reference ``Model.init`` tree of the
    dense, MoE (with or without MLA), RWKV, Griffin, enc-dec or patch-prefix
    LM, given as numpy arrays. A segment of ``count > 1`` units carries a
    leading ``layer`` axis on every leaf, unstacked here into a list of
    ``count`` units (an expert weight ``(L, E, d, F)`` becomes ``(E, d, F)``
    a unit, an RWKV ``mu`` ``(L, 5, d)`` becomes ``(5, d)``); a segment of
    one unit has none (a MoE config's ``first_dense`` segment, Griffin's
    remainder segment ``(rec, rec)``, or any segment of a smoke config with
    one unit). An enc-dec tree's ``encoder`` (``segment``, stacked the same
    way, and ``final_norm``) becomes ``{"segment": [unit, ...],
    "final_norm": ...}``; a cross layer's ``norm_x`` and ``cross``, and an
    MLA layer's latent projections and norms, carry over with the rest. The
    MTP head (``mtp``: no layer axis, its one layer unstacked in the
    reference too) carries over as it is. Every leaf keeps its dtype. Every
    leaf's path and shape must equal the port's declarations for ``cfg``
    (``transformer.model_decls``), else ValueError naming the paths that
    either side lacks."""
    def tree(node, pick):
        if isinstance(node, Mapping):
            return {k: tree(v, pick) for k, v in node.items()}
        return _tensor(pick(np.asarray(node)), device)

    out = {k: tree(v, lambda a: a) for k, v in params.items()
           if k not in ("segments", "encoder")}
    out["segments"] = [_unstack(seg, tree) for seg in params["segments"]]
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {k: tree(v, lambda a: a) for k, v in enc.items()
                          if k != "segment"}
        out["encoder"]["segment"] = _unstack(enc["segment"], tree)
    _check_against(out, model_decls(cfg))
    return out


def _leaf_shapes(node, path=""):
    if isinstance(node, Mapping):
        for k, v in node.items():
            yield from _leaf_shapes(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaf_shapes(v, f"{path}[{i}]")
    else:
        yield path, tuple(node.shape)


def _check_against(tree, decls) -> None:
    got, want = dict(_leaf_shapes(tree)), dict(_leaf_shapes(decls))
    if set(got) != set(want):
        raise ValueError(
            f"the reference tree lacks {sorted(set(want) - set(got))}; "
            f"the port does not declare {sorted(set(got) - set(want))}")
    bad = {p: (got[p], want[p]) for p in got if got[p] != want[p]}
    if bad:
        raise ValueError(f"shapes (reference, port) differ: {bad}")
