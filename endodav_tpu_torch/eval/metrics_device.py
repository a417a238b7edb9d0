"""TAE/TAS over every consecutive frame pair of a sequence in one pass of
tensor ops on the card.

Port of `endodav_tpu/eval/metrics_device.py`, with its semantics, which
are those of `eval/metrics.py:tae/tas`: pixel centres at +0.5, points with
z > 1e-6, the target pixel rounded to nearest, and the splat's
last-write-wins made exact by keeping, per target pixel, the highest point
index (`scatter_reduce(..., "amax")`: numpy's sequential splat keeps the
last point written); the symmetric mean of the two directions.  JAX's
version is `jnp`, not Pallas: PyTorch ops are its port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["temporal_metrics_sequence"]

_EPS = 1e-6


def _reproject(depth_src, mask_src, i2l_src, mask_tgt, l2i_tgt):
    """[P, H, W] source depths splatted into their targets' views: [P, H, W],
    zero where no point lands or the target mask is off."""
    p, h, w = depth_src.shape
    dev = depth_src.device
    ys, xs = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=dev),
                            torch.linspace(0.5, w - 0.5, w, device=dev), indexing="ij")
    pts = torch.stack([xs * depth_src, ys * depth_src, depth_src, torch.ones_like(depth_src)],
                      dim=-1).reshape(p, -1, 4)
    pts = pts @ i2l_src.transpose(1, 2)   # lidar frame
    pts = pts @ l2i_tgt.transpose(1, 2)   # target image frame
    z = pts[..., 2]
    ok = (z > _EPS) & mask_src.reshape(p, -1)
    cam = pts[..., :2] / pts[..., 2:3].clamp_min(_EPS)
    # clamped just outside the image before the integer cast, so that no
    # far point wraps into it
    cx = torch.round(cam[..., 0].clamp(-2.0, w + 1.0)).to(torch.int64)
    cy = torch.round(cam[..., 1].clamp(-2.0, h + 1.0)).to(torch.int64)
    ok &= (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    lin = torch.where(ok, cy * w + cx, torch.full_like(cx, h * w))  # out-of-image bucket
    order = torch.arange(h * w, device=dev).expand(p, -1)
    winner = torch.full((p, h * w + 1), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, lin, torch.where(ok, order, torch.full_like(order, -1)), "amax")[:, :h * w]
    depth_out = torch.where(winner >= 0, z.gather(1, winner.clamp_min(0)), torch.zeros_like(z))
    return depth_out.reshape(p, h, w) * mask_tgt


def _directional(depth_a, mask_a, i2l_a, depth_b, mask_b, l2i_b):
    a2b = _reproject(depth_a, mask_a, i2l_a, mask_b, l2i_b)
    m = (a2b > _EPS) & mask_b
    count = m.sum(dim=(1, 2)).clamp_min(1)
    safe_gt = torch.where(m, depth_b, torch.ones_like(depth_b))
    abs_rel = torch.where(m, (depth_b - a2b).abs() / safe_gt, 0.0).sum(dim=(1, 2)) / count
    ratio = torch.maximum(depth_b / torch.where(m, a2b, torch.ones_like(a2b)), a2b / safe_gt)
    d1 = torch.where(m, (ratio < 1.25).float(), 0.0).sum(dim=(1, 2)) / count
    return abs_rel, d1


@torch.no_grad()
def temporal_metrics_sequence(pred_depths, masks, img2lidars, device=None,
                              pairs_per_pass: int = 32):
    """Mean TAE (without the x100) and mean TAS over the consecutive frame
    pairs of one sequence.

    pred_depths [N, H, W] (aligned and clipped), masks [N, H, W] bool,
    img2lidars [N, 4, 4]: numpy, computed on ``device`` (default the CPU)
    in f32, ``pairs_per_pass`` pairs at a time (which bounds the memory,
    not the result); returns (tae_mean, tas_mean) floats."""
    device = torch.device("cpu") if device is None else device
    depths = torch.as_tensor(np.asarray(pred_depths, np.float32), device=device)
    m = torch.as_tensor(np.asarray(masks, bool), device=device)
    i2l_np = np.asarray(img2lidars)
    i2l = torch.as_tensor(i2l_np.astype(np.float32), device=device)
    l2i = torch.as_tensor(np.linalg.inv(i2l_np).astype(np.float32), device=device)
    tae, tas = [], []
    for p0 in range(0, len(depths) - 1, pairs_per_pass):
        a = slice(p0, min(p0 + pairs_per_pass, len(depths) - 1))
        b = slice(a.start + 1, a.stop + 1)
        e_ab, s_ab = _directional(depths[a], m[a], i2l[a], depths[b], m[b], l2i[b])
        e_ba, s_ba = _directional(depths[b], m[b], i2l[b], depths[a], m[a], l2i[a])
        tae.append(0.5 * (e_ab + e_ba))
        tas.append(0.5 * (s_ab + s_ba))
    return float(torch.cat(tae).mean()), float(torch.cat(tas).mean())
