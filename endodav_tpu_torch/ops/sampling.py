"""Differentiable image sampling and forward splatting.

Port of `endodav_tpu/ops/sampling.py`: the bilinear warp of the
self-supervised losses and the forward-splat occupancy map.  Every call
goes through `kernels/warp_matmul.py`, which launches the CUDA kernels on
a CUDA tensor and runs their plain versions on a CPU tensor.  (The JAX
package routes to its Pallas kernels only when an image fits the TPU's
4 MB VMEM block; that limit is the TPU's and is not copied.)

All images are channels-last ``[B, H, W, C]``; flow fields follow the
reference's ``(dy, dx)`` channel order; normalized grids use ``(x, y)``
like `torch.nn.functional.grid_sample`.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.geometry.losses import abs_jax
from endodav_tpu_torch.kernels.warp_matmul import grid_sample_mm, splat_mm

__all__ = ["grid_sample", "flow_to_grid", "flow_warp", "forward_splat_occupancy",
           "occlusion_mask_backward", "flow_consistency"]


def grid_sample(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border",
                align_corners: bool = True, img_grad: bool = True,
                img_tile: int = 1) -> torch.Tensor:
    """Bilinear sampling with torch `grid_sample` semantics.

    img [B, H, W, C]; grid [B*img_tile, Ho, Wo, 2] with normalized (x, y).
    ``img_grad=False`` declares the image gradient-free (the coordinate-
    only backward kernel runs); ``img_tile > 1`` lets grid element bi
    sample img[bi // img_tile] (requires ``img_grad=False``).  Integer
    images are gathered, then blended in f32 and returned in f32.
    """
    integer_img = not img.is_floating_point()
    _, h, w, _ = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (w - 1)
        fy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1.0) * w - 1.0) * 0.5
        fy = ((gy + 1.0) * h - 1.0) * 0.5
    src = img.float() if integer_img else img
    out = grid_sample_mm(src, fx, fy, padding_mode == "zeros", img_grad, img_tile)
    return out if integer_img else out.to(img.dtype)


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=like.dtype, device=like.device),
                            torch.arange(w, dtype=like.dtype, device=like.device),
                            indexing="ij")
    return yy, xx


def flow_to_grid(flow: torch.Tensor) -> torch.Tensor:
    """Pixel displacement [B, H, W, 2] (dy, dx) -> normalized (x, y) grid,
    align_corners=True convention."""
    _, h, w, _ = flow.shape
    yy, xx = _pixel_grid(h, w, flow)
    ny = yy[None] + flow[..., 0]
    nx = xx[None] + flow[..., 1]
    return torch.stack([2.0 * (nx / (w - 1) - 0.5), 2.0 * (ny / (h - 1) - 0.5)], dim=-1)


def flow_warp(src: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border",
              img_grad: bool = True, img_tile: int = 1) -> torch.Tensor:
    """Warp ``src`` [B, H, W, C] by a displacement field [B*img_tile, H, W, 2]
    (dy, dx) (SpatialTransformer parity)."""
    return grid_sample(src, flow_to_grid(flow), padding_mode=padding_mode,
                       img_grad=img_grad, img_tile=img_tile)


def forward_splat_occupancy(coords_xy: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear forward-splat of unit mass at pixel coords [B, H, W, 2]
    (x, y) -> occupancy [B, height, width, 1] (`get_corresponding_map`
    conventions)."""
    b = coords_xy.shape[0]
    occ = splat_mm(coords_xy[..., 0].reshape(b, -1), coords_xy[..., 1].reshape(b, -1),
                   height, width)
    return occ.reshape(b, height, width, 1).to(coords_xy.dtype)


def occlusion_mask_backward(flow_reverse: torch.Tensor, th: float = 0.95):
    """Occupancy-based backward occlusion mask; flow [B, H, W, 2] (dy, dx)
    -> (mask, map), both [B, H, W, 1], mask = (occupancy > th)."""
    _, h, w, _ = flow_reverse.shape
    yy, xx = _pixel_grid(h, w, flow_reverse)
    tx = xx[None] + flow_reverse[..., 1]
    ty = yy[None] + flow_reverse[..., 0]
    occu_map = forward_splat_occupancy(torch.stack([tx, ty], dim=-1), h, w)
    return (occu_map > th).to(flow_reverse.dtype), occu_map


def flow_consistency(flow12: torch.Tensor, flow21: torch.Tensor) -> torch.Tensor:
    """|flow12 + warp(flow21, flow12)|; both [B, H, W, 2] (dy, dx).  The
    warp keeps the reference's align_corners=False."""
    _, h, w, _ = flow12.shape
    yy, xx = _pixel_grid(h, w, flow12)
    ny = yy[None] + flow12[..., 0]
    nx = xx[None] + flow12[..., 1]
    grid = torch.stack([2.0 * (nx / (w - 1) - 0.5), 2.0 * (ny / (h - 1) - 0.5)], dim=-1)
    warped = grid_sample(flow21, grid, padding_mode="border", align_corners=False)
    return abs_jax(flow12 + warped)
