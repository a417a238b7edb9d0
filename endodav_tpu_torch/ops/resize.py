"""Separable image resize as two dense interpolation matmuls.

Port of `endodav_tpu/ops/resize.py`.  The numpy `interp_matrix` is
copied verbatim, so the coordinate semantics match the JAX package
exactly:

* torch ``align_corners=True``  : src = dst * (in-1)/(out-1)
* torch ``align_corners=False`` : src = (dst+0.5)/scale - 0.5 (scale=out/in
  unless an explicit scale factor is given), border-clamped
* bicubic: Keys kernel with a = -0.75 (torch and OpenCV both use -0.75)
* antialiased bilinear: triangle filter stretched by the downscale factor,
  out-of-range taps dropped and the rest renormalized (torchvision
  ``antialias=True``; the training pyramid)

The JAX version's nearest mode is not carried over.

`resize2d` applies ``out = M_h @ x @ M_w^T`` over channels-last input.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interp_matrix", "resize2d"]


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys bicubic kernel with parameter ``a`` (torch/cv2 use a=-0.75)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=None)
def interp_matrix(
    in_size: int,
    out_size: int,
    method: str = "bilinear",
    align_corners: bool = False,
    scale: float | None = None,
    antialias: bool = False,
) -> np.ndarray:
    """Dense (out_size, in_size) float32 interpolation matrix.

    ``scale``, when given, overrides out/in for the coordinate mapping
    (`F.interpolate(..., scale_factor=s)` semantics, used for the ViT
    pos-embed interpolation).
    """
    if in_size == out_size and not antialias:
        return np.eye(out_size, dtype=np.float32)

    dst = np.arange(out_size, dtype=np.float64)
    eff_scale = scale if scale is not None else out_size / in_size

    if align_corners:
        src = np.zeros_like(dst) if out_size == 1 else dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) / eff_scale - 0.5

    if method == "bilinear":
        kernel, support = _triangle_kernel, 1.0
    elif method == "bicubic":
        kernel, support = _cubic_kernel, 2.0
    else:
        raise ValueError(f"unknown resize method: {method}")

    # antialias: stretch the kernel by the downscale factor
    stretch = antialias and eff_scale < 1.0
    kwidth, kscale = (support / eff_scale, eff_scale) if stretch else (support, 1.0)

    lo = np.floor(src - kwidth).astype(np.int64)
    hi = np.ceil(src + kwidth).astype(np.int64)
    max_taps = int((hi - lo).max()) + 1

    taps = lo[:, None] + np.arange(max_taps)[None, :]
    w = kernel((taps - src[:, None]) * kscale)
    if stretch:  # drop out-of-range taps and renormalize over the rest
        w = np.where((taps < 0) | (taps > in_size - 1), 0.0, w)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)

    # border clamp (replicate edge pixels), as torch/cv2 do
    taps = np.clip(taps, 0, in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(m, (np.repeat(np.arange(out_size), max_taps), taps.ravel()), w.ravel())
    return m.astype(np.float32)


def resize2d(
    x: torch.Tensor,
    size: tuple[int, int],
    method: str = "bilinear",
    align_corners: bool = False,
    scale_hw: tuple[float, float] | None = None,
    antialias: bool = False,
) -> torch.Tensor:
    """Resize the (H, W) dims of a channels-last tensor ``(..., H, W, C)``.

    Half-precision inputs use matrices of their own dtype (the bilinear
    weights are dyadic and exact in bf16); f32 inputs keep f32 matrices.
    """
    *lead, h, w, c = x.shape
    oh, ow = size
    if (oh, ow) == (h, w) and not antialias:
        return x
    sh, sw = scale_hw if scale_hw is not None else (None, None)
    mdtype = x.dtype if x.dtype in (torch.bfloat16, torch.float16) else torch.float32
    mh = torch.from_numpy(interp_matrix(h, oh, method, align_corners, sh, antialias)).to(
        device=x.device, dtype=mdtype)
    mw = torch.from_numpy(interp_matrix(w, ow, method, align_corners, sw, antialias)).to(
        device=x.device, dtype=mdtype)
    y = x.reshape(-1, h, w, c).to(mdtype)
    # rows: [P, H] @ [B, H, W*C] -> [B, P, W*C]
    y = torch.matmul(mh, y.reshape(-1, h, w * c))
    # columns: [Q, W] @ [B*P, W, C] -> [B*P, Q, C]
    y = torch.matmul(mw, y.reshape(-1, w, c))
    return y.reshape(*lead, oh, ow, c).to(x.dtype)
