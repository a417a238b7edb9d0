"""Geometry utilities off the training and eval paths.

Port of `endodav_tpu/geometry/extras.py`, the remaining utils/layers.py
pieces the reference exposes: `project_raw_pixels` (Project3D_Raw
:192-213), `flow_match` (match :522-540) and `texture_mask`
(get_texu_mask :543-549) on tensors, on their device; `reduced_ransac`
(:627-683, cv2 fundamental-matrix RANSAC over the top-scoring flow
matches) on the host, as JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["project_raw_pixels", "flow_match", "texture_mask", "reduced_ransac"]


def project_raw_pixels(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor, height: int,
                       width: int, eps: float = 1e-7) -> torch.Tensor:
    """points [B, 4, H*W], K and T [B, 4, 4] -> unnormalized pixel coords
    [B, H, W, 2] (x, y)."""
    b = points.shape[0]
    P = torch.matmul(K, T)[:, :3, :]
    cam = torch.einsum("bij,bjn->bin", P, points)
    xy = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    return xy.reshape(b, 2, height, width).permute(0, 2, 3, 1)


def flow_match(flow: torch.Tensor) -> torch.Tensor:
    """(source xy, target xy) match maps [B, H, W, 4] from a (dy, dx) flow
    field [B, H, W, 2]."""
    b, h, w, _ = flow.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    src = torch.stack([xx, yy], dim=-1)[None].expand(b, h, w, 2)
    tgt = torch.stack([xx[None] + flow[..., 1], yy[None] + flow[..., 0]], dim=-1)
    return torch.cat([src, tgt], dim=-1)


def texture_mask(non_rigid: torch.Tensor, rigid: torch.Tensor) -> torch.Tensor:
    """Rigid-vs-nonrigid flow agreement mask [..., 1]."""
    diff = ((non_rigid - rigid) ** 2).mean(dim=-1, keepdim=True)
    total = 0.01 * ((non_rigid ** 2).mean(-1, keepdim=True)
                    + (rigid ** 2).mean(-1, keepdim=True)) + 0.5
    return (diff < total).to(non_rigid.dtype)


def reduced_ransac(match: np.ndarray, mask: np.ndarray, check_num: int = 6000,
                   dataset: str = "scared", top_ratio: float = 0.20,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Fundamental matrices [B, 3, 3] from flow matches via cv2 RANSAC.

    match: [B, H, W, 4] (src xy, tgt xy); mask: [B, H, W, 1] scores
    (numpy, or tensors, which are copied to the host).
    """
    import cv2

    match, mask = (x.detach().cpu().numpy() if torch.is_tensor(x) else x for x in (match, mask))
    rng = rng or np.random.default_rng(0)
    b = match.shape[0]
    match_flat = match.reshape(b, -1, 4)
    mask_flat = mask.reshape(b, -1)

    out = []
    for i in range(b):
        scores = mask_flat[i]
        k = max(8, int(top_ratio * scores.shape[0]))
        top_idx = np.argpartition(-scores, k - 1)[:k]
        pick = top_idx[rng.integers(0, len(top_idx), size=min(check_num, len(top_idx)))]
        pts = match_flat[i][pick]
        if dataset == "nyuv2":
            f, _ = cv2.findFundamentalMat(pts[:, :2], pts[:, 2:], cv2.FM_LMEDS, 0.99)
        else:
            f, _ = cv2.findFundamentalMat(pts[:, :2], pts[:, 2:], cv2.FM_RANSAC, 0.1, 0.99)
        out.append(np.eye(3, dtype=np.float64) if f is None else f[:3])
    return np.stack(out, axis=0)
