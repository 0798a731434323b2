# Port of repro/common/dots.py (einsum_f32).
"""Mixed-precision product helper.

``einsum_f32`` accumulates in fp32 over operands held in their storage
dtype. The reference hands bf16 operands to the MXU with an fp32
accumulator on the TPU and casts them to fp32 off it; here the operands
are cast to fp32 and multiplied in fp32 (a bf16 x bf16 product is exact
in fp32, so the sums are those of an fp32 accumulator), on every device.
"""
from __future__ import annotations

import torch


def einsum_f32(spec: str, lhs: torch.Tensor, rhs: torch.Tensor
               ) -> torch.Tensor:
    """einsum with fp32 accumulation; returns fp32."""
    return torch.einsum(spec, lhs.float(), rhs.float())
