"""Fused-QKV multi-head attention for the ViT blocks.

Port of `endodav_tpu/ops/attention.py:fused_qkv_attention`.  The packed
projection ``x W^T + b`` stays a plain matmul (the JAX package leaves it
to XLA outside the pallas_call); the attention itself is the flash
kernel, which reads q, k and v as strided views of the packed result.

With ``quant_int8`` the packed projection is `int8_dense` over the whole
[3C, C] weight: one per-row quantization of x, shared by the q, k and v
column panels (the per-output-channel weight scales make that the same as
JAX's three panel products with a shared ``x_quant``,
`kernels/flash_attention.py:113-126`), then the flash kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endodav_tpu_torch.kernels.flash_attention import qkv_attention
from endodav_tpu_torch.ops.quant import int8_dense

__all__ = ["fused_qkv_attention"]


def fused_qkv_attention(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        heads: int, scale: float | None = None,
                        quant_int8: bool = False) -> torch.Tensor:
    """MHSA over x [B, N, C] with one packed projection weight [3C, C]
    (torch Linear layout) and optional bias [3C]; returns [B, N, C]."""
    qkv = int8_dense(x, weight, bias) if quant_int8 else F.linear(x, weight, bias)
    return qkv_attention(qkv, heads, scale)
