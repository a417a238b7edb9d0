"""Photometric, smoothness and correlation losses (channels-last).

Port of `endodav_tpu/geometry/losses.py`: SSIM, the 0.85*SSIM + 0.15*L1
reprojection loss, edge-aware smoothness, the residue-aware appearance
smoothness, flow smoothness, local NCC and the reverse Huber loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["abs_jax", "clip_jax", "ssim", "reprojection_loss", "smooth_loss", "smooth_bright",
           "smooth_registration", "ncc", "berhu"]


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient: +1 at x == 0, where `torch.abs` gives 0.
    Neighbouring flows of the at-init position nets and flat image regions
    have differences of exactly 0, so the choice moves the gradients."""
    return torch.where(x >= 0, x, -x)


def clip_jax(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with its gradient: 0.5 at x == lo or x == hi (max/min
    share a tie), where `torch.clamp` passes 1."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _avg_pool3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean after a 1-pixel reflection pad; x [B, H, W, C]."""
    y = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.avg_pool2d(y, 3, stride=1).permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM distance in [0, 1]; inputs [B, H, W, C]."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x = _avg_pool3_reflect(x)
    mu_y = _avg_pool3_reflect(y)
    sigma_x = _avg_pool3_reflect(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3_reflect(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3_reflect(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return clip_jax((1.0 - n / d) * 0.5, 0.0, 1.0)


def reprojection_loss(pred, target, use_ssim: bool = True):
    """0.85*SSIM + 0.15*L1 per pixel, averaged over channels -> [B, H, W, 1]."""
    l1 = abs_jax(target - pred).mean(-1, keepdim=True)
    if not use_ssim:
        return l1
    return 0.85 * ssim(pred, target).mean(-1, keepdim=True) + 0.15 * l1


def _dx(a):
    return abs_jax(a[:, :, :-1] - a[:, :, 1:])


def _dy(a):
    return abs_jax(a[:, :-1, :] - a[:, 1:, :])


def smooth_loss(disp, img):
    """Edge-aware first-order smoothness; inputs [B, H, W, C]."""
    gix = _dx(img).mean(-1, keepdim=True)
    giy = _dy(img).mean(-1, keepdim=True)
    return (_dx(disp) * torch.exp(-gix)).mean() + (_dy(disp) * torch.exp(-giy)).mean()


def smooth_bright(transform, target, pred, occu_mask):
    """Residue-aware appearance-flow smoothness."""
    gtx = _dx(transform).mean(-1, keepdim=True)
    gty = _dy(transform).mean(-1, keepdim=True)
    residue = target - pred
    grx = _dx(residue).mean(-1, keepdim=True)
    gry = _dy(residue).mean(-1, keepdim=True)
    mask_x = occu_mask[:, :, :-1]
    mask_y = occu_mask[:, :-1, :]
    return ((gtx * torch.exp(-grx) * mask_x).sum() / mask_x.sum()
            + (gty * torch.exp(-gry) * mask_y).sum() / mask_y.sum())


def smooth_registration(position):
    """First-order flow smoothness without edge weighting."""
    return _dx(position).mean() + _dy(position).mean()


def ncc(i, j, win: int = 5):
    """Negative local normalized cross-correlation; inputs [B, H, W, 1]."""
    ones = torch.ones((1, 1, win, win), dtype=i.dtype, device=i.device)

    def box(x):
        return F.conv2d(x.permute(0, 3, 1, 2), ones, padding=win // 2).permute(0, 2, 3, 1)

    i_sum, j_sum = box(i), box(j)
    i2_sum, j2_sum, ij_sum = box(i * i), box(j * j), box(i * j)
    n = float(win * win)
    u_i, u_j = i_sum / n, j_sum / n
    cross = ij_sum - u_j * i_sum - u_i * j_sum + u_i * u_j * n
    i_var = i2_sum - 2 * u_i * i_sum + u_i * u_i * n
    j_var = j2_sum - 2 * u_j * j_sum + u_j * u_j * n
    return -(cross * cross / (i_var * j_var + 1e-5))


def berhu(pred, target):
    """Reverse Huber loss: |d| up to c = 0.2 max|d| (no gradient through c),
    (d^2 + c^2) / 2c above it; the mean."""
    diff = pred - target
    abs_diff = abs_jax(diff)
    c = 0.2 * abs_diff.max().detach()
    l2 = (diff ** 2 + c ** 2) / (2.0 * c)
    return torch.where(abs_diff <= c, abs_diff, l2).mean()
