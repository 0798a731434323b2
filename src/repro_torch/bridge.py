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
* ``head_state`` / ``set_initial_head``: a softmax head (trained, or the
  reference's ``init_head()`` that every fit starts from).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

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
