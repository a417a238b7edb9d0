"""Dynamic int8 GEMMs for the serving-time ViT projections.

Port of `endodav_tpu/ops/quant.py:57-127`.  Symmetric per-row int8 scales
for the activations (``amax / 127`` over the contraction axis, computed on
the fly), symmetric per-output-channel scales for the weights (quantized
from the live float weight at every call), an exact integer contraction,
and the f32 epilogue ``acc * x_scale * w_scale + bias`` in that order.
``torch.round`` and ``jnp.round`` both round half to even.

Weights are in the torch Linear layout [out, in]; the per-output-channel
scale is the JAX one (``amax`` over the input axis).

The contraction: on CUDA ``torch._int_mm`` (int8 x int8 -> int32, the
counterpart of the XLA ``dot_general`` that the JAX package leaves outside
any Pallas body), which needs more than 16 rows and both other sizes a
multiple of 8, checked here; on the CPU an int64 matmul, exact for every
sum these layers reach (|sum| <= 127^2 * 4096, about 6.6e7, which f32 would
round).

Serving only: ``round`` has zero gradient.  The model config carries the
decision (`EndoDAV.int8_serving`, set by the engine for merged vitl);
``ENDODAV_INT8`` overrides it when explicitly set (`resolve_int8`).
"""

from __future__ import annotations

import os

import torch

from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["resolve_int8", "quantize_weight", "quantize_rows", "int8_dense", "int_matmul"]


def resolve_int8(flag: bool | None = None) -> bool:
    """Whether a forward serves int8 GEMMs: an explicitly set
    ``ENDODAV_INT8`` wins either way; otherwise the model's flag."""
    if "ENDODAV_INT8" in os.environ:
        return env_on("ENDODAV_INT8")
    return bool(flag)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel int8 of a [out, in] weight: (w8 int8 [out, in],
    scale f32 [out])."""
    w = w.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return w8, scale


def quantize_rows(x: torch.Tensor):
    """Per-row int8 over the last axis: (x8 int8, scale f32 [..., 1])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    x8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x8, scale


def int_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact a8 [M, K] @ w8[N, K]^T of int8 matrices.  CUDA: ``torch._int_mm``
    into int32; CPU: the plain version, an int64 matmul."""
    m, k = a8.shape
    n = w8.shape[0]
    if a8.device.type == "cpu":
        return a8.long() @ w8.long().t()
    if a8.device.type != "cuda":
        raise ValueError(f"int_matmul: unsupported device {a8.device}")
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"int_matmul: torch._int_mm needs M > 16 and K, N multiples of 8, "
                         f"got M={m} K={k} N={n}")
    return torch._int_mm(a8.contiguous(), w8.t())


def int8_dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w^T (+ bias) with the contraction in int8; x [..., in], w
    [out, in].  The epilogue runs in f32 and the result is cast to
    ``out_dtype`` (default x's dtype), as JAX's `int8_dense` (:102-127)."""
    w8, w_scale = quantize_weight(w)
    x8, x_scale = quantize_rows(x)
    lead = x8.shape[:-1]
    acc = int_matmul(x8.reshape(-1, x8.shape[-1]), w8.contiguous())
    y = acc.float().reshape(*lead, -1) * x_scale * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)
