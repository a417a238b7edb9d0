"""Fused-QKV multi-head attention for the ViT blocks.

Port of `endodav_tpu/ops/attention.py:fused_qkv_attention`.  The packed
projection ``x W^T + b`` stays a plain matmul (the JAX package leaves it
to XLA outside the pallas_call); the attention itself is the flash
kernel, which reads q, k and v as strided views of the packed result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endodav_tpu_torch.kernels.flash_attention import qkv_attention

__all__ = ["fused_qkv_attention"]


def fused_qkv_attention(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        heads: int, scale: float | None = None) -> torch.Tensor:
    """MHSA over x [B, N, C] with one packed projection weight [3C, C]
    (torch Linear layout) and optional bias [3C]; returns [B, N, C]."""
    return qkv_attention(F.linear(x, weight, bias), heads, scale)
