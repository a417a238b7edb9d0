"""Compute-dtype cast points of the serving modules, as flax places them.

The JAX package builds its serving modules with ``dtype=jnp.bfloat16``
and keeps the parameters in f32 (flax's ``param_dtype``).  The port does
the same: a module holds f32 parameters and a compute ``dtype``, and
casts where flax does.

* `dense` and `conv_nhwc` are ``nn.Dense`` / ``nn.Conv`` with ``dtype``:
  the input, the kernel and the bias are cast to it
  (``flax.linen.dtypes.promote_dtype``), so the product comes out in it.
* `layer_norm` and `group_norm` are ``nn.LayerNorm`` / ``nn.GroupNorm``
  with ``dtype``: mean, variance, scale and bias in f32
  (``force_float32_reductions``), only the output cast to ``dtype``.

At f32 every cast is the identity and each helper is the PyTorch module's
own forward, so an f32 model computes exactly what it did without them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["conv_nhwc", "dense", "layer_norm", "group_norm"]


def conv_nhwc(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Apply an NCHW conv module to a channels-last [B, H, W, C] tensor (the
    permuted views are channels_last memory format, so no copy is made);
    with ``dtype``, input, kernel and bias in that dtype."""
    if dtype is not None:
        x = x.to(dtype)
    xc = x.permute(0, 3, 1, 2)
    if dtype is None or conv.weight.dtype == dtype:
        return conv(xc).permute(0, 2, 3, 1)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(xc, w, b, conv.stride, conv.padding, conv.output_padding,
                               conv.groups, conv.dilation)
    else:
        y = F.conv2d(xc, w, b, conv.stride, conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)`` with the weights of an ``nn.Linear``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype,
               eps: float | None = None) -> torch.Tensor:
    """``nn.LayerNorm(dtype=dtype)`` over the last axis: statistics, scale and
    bias in f32, the output cast; ``eps`` defaults to the module's."""
    eps = norm.eps if eps is None else eps
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        eps).to(dtype)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``nn.GroupNorm(dtype=dtype)`` over channels-last [B, H, W, C]:
    statistics, scale and bias in f32, the output cast."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), norm.num_groups, norm.weight, norm.bias,
                     norm.eps)
    return y.permute(0, 2, 3, 1).to(dtype)
