"""Differentiable camera geometry.

Port of `endodav_tpu/geometry/transforms.py`: disparity to depth, SE(3)
from axis-angle and translation, back-projection of a depth map,
projection into a normalized `grid_sample` grid and the rigid flow.  Pure
functions of tensors; pixel grids are built on the input's device, in the
dtype JAX builds them in (the depth's or the points').

Mixed dtypes promote as in JAX: a bf16 depth or pose meets the f32
intrinsics in a product that comes out f32 (`_matmul`; PyTorch's matmul
refuses mixed dtypes, and JAX's ``einsum`` promotes).  Python scalars are
weak in both, so ``disp_to_depth`` keeps a bf16 disparity in bf16.
"""

from __future__ import annotations

import torch

__all__ = ["disp_to_depth", "rot_from_axisangle", "translation_matrix",
           "transformation_from_parameters", "pixel_grid_homogeneous", "backproject_depth",
           "project_3d", "rigid_flow"]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX promotes the two to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth) in [min_depth, max_depth].
    Works on numpy arrays and torch tensors alike."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> 4x4 homogeneous rotation [..., 4, 4]."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c1 = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c1, y * c1, z * c1
    xyc, yzc, zxc = x * yc, y * zc, z * xc
    zeros, ones = torch.zeros_like(ca), torch.ones_like(ca)
    rot = torch.stack([
        x * xc + ca, xyc - zs, zxc + ys, zeros,
        xyc + zs, y * yc + ca, yzc - xs, zeros,
        zxc - ys, yzc + xs, z * zc + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1)
    return rot.reshape(*vec.shape[:-1], 4, 4)


def translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation [..., 3] -> 4x4 homogeneous matrix."""
    eye = torch.eye(4, dtype=t.dtype, device=t.device).expand(*t.shape[:-1], 4, 4)
    col = torch.cat([t, torch.ones_like(t[..., :1])], dim=-1)[..., None]
    return torch.cat([eye[..., :3], col], dim=-1)


def transformation_from_parameters(axisangle, translation, invert: bool = False):
    """(axis-angle [..., 3], translation [..., 3]) -> SE(3) [..., 4, 4]."""
    rot = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        rot = rot.transpose(-1, -2)
        t = -t
    trans = translation_matrix(t)
    return rot @ trans if invert else trans @ rot


def pixel_grid_homogeneous(height: int, width: int, dtype=torch.float32,
                           device=None) -> torch.Tensor:
    """[3, H*W] homogeneous pixel coordinates (x, y, 1), row-major."""
    yy, xx = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1), torch.ones_like(xx).reshape(-1)])


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth [B, H, W(, 1)] + inv_K [B, 4, 4] -> camera points [B, 4, H*W]."""
    if depth.ndim == 4:
        depth = depth[..., 0]
    b, h, w = depth.shape
    pix = pixel_grid_homogeneous(h, w, depth.dtype, depth.device)
    cam = depth.reshape(b, 1, -1) * _matmul(inv_K[:, :3, :3], pix)
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points, K, T, height: int, width: int, eps: float = 1e-7):
    """Project camera points [B, 4, H*W] through K @ T.  Returns (grid
    [B, H, W, 2] normalized (x, y), src_depths [B, 1, H*W])."""
    b = points.shape[0]
    cam = _matmul(_matmul(K, T)[:, :3, :], points)
    z = cam[:, 2:3, :]
    xy = (cam[:, :2, :] / (z + eps)).reshape(b, 2, height, width)
    gx = (xy[:, 0] / (width - 1) - 0.5) * 2.0
    gy = (xy[:, 1] / (height - 1) - 0.5) * 2.0
    return torch.stack([gx, gy], dim=-1), z


def rigid_flow(points, K, T, height: int, width: int, eps: float = 1e-7):
    """The (dy, dx) flow [B, H, W, 2] that depth and pose induce: camera
    points [B, 4, H*W] projected through K @ T, minus the pixel grid (in
    the points' dtype)."""
    b = points.shape[0]
    cam = _matmul(_matmul(K, T)[:, :3, :], points)
    xy = (cam[:, :2, :] / (cam[:, 2:3, :] + eps)).reshape(b, 2, height, width)
    yy, xx = torch.meshgrid(torch.arange(height, dtype=points.dtype, device=points.device),
                            torch.arange(width, dtype=points.dtype, device=points.device),
                            indexing="ij")
    return torch.stack([xy[:, 1] - yy[None], xy[:, 0] - xx[None]], dim=-1)
