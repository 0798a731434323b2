"""ResNet feature extractor in PyTorch (port of repro/models/resnet.py).

The public layout is the reference's: NHWC images in, ``(B, widths[-1])``
pooled features out. Inside, tensors are NCHW as PyTorch's convolutions
want them. Two details keep the floats close to the reference:

* padding is XLA's ``"SAME"``, written out explicitly: at stride 2 the
  odd pad goes bottom/right, which ``Conv2d(padding=1)`` would get wrong;
* ``_norm`` uses per-sample statistics over H and W (population variance,
  eps 1e-5), never batch statistics, so a row's features are a function of
  that row alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)       # resnet-18
    widths: Sequence[int] = (64, 128, 256, 512)
    in_channels: int = 3
    num_classes: int = 10


def resnet18_config() -> ResNetConfig:
    return ResNetConfig()


def tiny_config(num_classes: int = 10) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(1, 1), widths=(16, 32),
                        num_classes=num_classes)


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """XLA "SAME" convolution; x NCHW, w OIHW."""
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def _norm(x, scale):
    mu = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale[None, :, None, None]


class ResNet(nn.Module):
    """Frozen ResNet trunk. Parameters follow the reference's tree:
    ``stem`` and, per block, ``conv1``/``conv2``/``scale1``/``scale2`` and
    ``proj`` where the width changes (convolutions stored OIHW)."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(42)

        def conv(cin, cout, k=3):
            # the reference's init: normal / sqrt(fan_in), fan_in = k*k*cin
            w = torch.randn((cout, cin, k, k), generator=g) \
                / math.sqrt(k * k * cin)
            return nn.Parameter(w.to(device), requires_grad=False)

        def ones(n):
            return nn.Parameter(torch.ones((n,), device=device),
                                requires_grad=False)

        self.stem = conv(cfg.in_channels, cfg.widths[0])
        self.blocks = nn.ModuleList()
        cin = cfg.widths[0]
        for n, w in zip(cfg.stage_sizes, cfg.widths):
            for _ in range(n):
                b = nn.Module()
                b.conv1 = conv(cin, w)
                b.conv2 = conv(w, w)
                b.scale1 = ones(w)
                b.scale2 = ones(w)
                if cin != w:
                    b.proj = conv(cin, w, k=1)
                self.blocks.append(b)
                cin = w

    @torch.no_grad()
    def forward(self, x):
        """x: (B,H,W,C) fp32 in [0,1] -> (B, widths[-1]) pooled features."""
        h = F.relu(_conv(x.permute(0, 3, 1, 2), self.stem))
        bi = 0
        for si, n in enumerate(self.cfg.stage_sizes):
            for k in range(n):
                b = self.blocks[bi]
                stride = 2 if (k == 0 and si > 0) else 1
                y = F.relu(_norm(_conv(h, b.conv1, stride), b.scale1))
                y = _norm(_conv(y, b.conv2), b.scale2)
                sc = _conv(h, b.proj, stride) if hasattr(b, "proj") else h
                h = F.relu(y + sc)
                bi += 1
        return torch.mean(h, dim=(2, 3))
