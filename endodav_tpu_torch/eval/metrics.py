"""Depth / temporal / pose metrics and alignment (numpy host-side).

A copy of `endodav_tpu/eval/metrics.py`: that package cannot be imported
without jax, so the port carries its own numpy copy.

Counterparts of the reference metric stack (SURVEY.md §2.4):
  * depth errors abs_rel..δ3 (utils/utils.py:112-133, eval_utils.py:14-61)
  * TAE / TAS cross-frame reprojection metrics (eval_utils.py:64-143)
  * median / shift-and-scale alignment (eval_utils.py:265-282)
  * closed-form scale/shift fit for window stitching (utils/util.py:16-62)
  * linear cross-fade of overlap frames (utils/util.py:65-74)
  * pose track metrics ATE / RE + trajectory accumulation
    (utils/utils.py:156-224)

These run on full-resolution GT (1024x1280) once per frame — host numpy
is the right tool; the training-time on-device metric variant lives in
train/losses.py.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "compute_errors",
    "abs_rel",
    "log10",
    "silog",
    "delta_threshold",
    "tae",
    "tas",
    "median_scaling",
    "align_shift_and_scale",
    "compute_scale_and_shift",
    "interpolate_frames",
    "dump_xyz",
    "dump_r",
    "dump_poses",
    "compute_ate",
    "compute_re",
    "compute_pose_scale",
]


# ---------------------------------------------------------------- depth

def abs_rel(gt, pred):
    return float(np.mean(np.abs(gt - pred) / gt))


def delta_threshold(gt, pred, exp: int = 1):
    thresh = np.maximum(gt / pred, pred / gt)
    return float((thresh < 1.25 ** exp).mean())


def log10(gt, pred):
    return float(np.abs(np.log10(pred) - np.log10(gt)).mean())


def silog(gt, pred):
    err = np.log(pred) - np.log(gt)
    return float(100.0 * np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2))


def compute_errors(gt, pred, mask=None):
    """(abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) over masked pixels."""
    if mask is not None:
        gt, pred = gt[mask], pred[mask]
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    ar = np.mean(np.abs(gt - pred) / gt)
    sr = np.mean(((gt - pred) ** 2) / gt)
    return ar, sr, rmse, rmse_log, a1, a2, a3


# ------------------------------------------------- temporal consistency

def _unproject(depth, mask, img2lidar):
    """Pixels (+0.5 centers) with depth -> 3D points (eval_utils.py:64-77)."""
    h, w = depth.shape
    ys, xs = np.meshgrid(
        np.linspace(0.5, h - 0.5, h), np.linspace(0.5, w - 0.5, w), indexing="ij"
    )
    pts = np.stack([xs, ys, depth, np.ones_like(xs)], axis=-1)[mask]
    pts[..., :2] *= pts[..., 2:3]
    pts = pts @ img2lidar.T
    return pts[..., :3]


def _reproject(points, warp_mask, warp_img2lidar):
    """3D points -> z-buffer-free depth map in the target view
    (eval_utils.py:80-101: last-write-wins nearest-pixel splat)."""
    pts = np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)
    pts = pts @ np.linalg.inv(warp_img2lidar).T
    depth = pts[..., 2]
    eps = 1e-6
    ok = depth > eps
    cam = pts[..., :2] / np.clip(pts[..., 2:3], eps, None)
    coords = np.round(cam).astype(np.int32)
    h, w = warp_mask.shape
    ok &= (coords[..., 0] >= 0) & (coords[..., 0] < w) & (coords[..., 1] >= 0) & (coords[..., 1] < h)
    out = np.zeros((h, w), dtype=np.float32)
    out[coords[ok][..., 1], coords[ok][..., 0]] = depth[ok]
    return out * warp_mask


def _pairwise(metric, depth_a, mask_a, i2l_a, depth_b, mask_b, i2l_b):
    a2b = _reproject(_unproject(depth_a, mask_a, i2l_a), mask_b, i2l_b)
    m = (a2b > 1e-6) & mask_b
    e_ab = metric(depth_b[m], a2b[m])
    b2a = _reproject(_unproject(depth_b, mask_b, i2l_b), mask_a, i2l_a)
    m = (b2a > 1e-6) & mask_a
    e_ba = metric(depth_a[m], b2a[m])
    return 0.5 * (e_ab + e_ba)


def tae(depth_a, mask_a, i2l_a, depth_b, mask_b, i2l_b):
    """Temporal alignment error (symmetric abs_rel after reprojection)."""
    return _pairwise(abs_rel, depth_a, mask_a, i2l_a, depth_b, mask_b, i2l_b)


def tas(depth_a, mask_a, i2l_a, depth_b, mask_b, i2l_b):
    """Temporal alignment score (symmetric δ1 after reprojection)."""
    return _pairwise(delta_threshold, depth_a, mask_a, i2l_a, depth_b, mask_b, i2l_b)


# ------------------------------------------------------------ alignment

def median_scaling(gt_depths, pred_depths, min_depth=1e-3, max_depth=150.0):
    valid = (gt_depths > min_depth) & (gt_depths < max_depth)
    ratio = np.median(gt_depths[valid]) / np.median(pred_depths[valid])
    return pred_depths * ratio, ratio


def align_shift_and_scale(gt_depths, pred_depths, min_depth=1e-3, max_depth=150.0):
    """Median/MAD matching; returns (aligned, t_gt, s_gt, t_pred, s_pred)."""
    valid = (gt_depths > min_depth) & (gt_depths < max_depth)
    gt_v, pred_v = gt_depths[valid], pred_depths[valid]
    t_gt = np.median(gt_v)
    s_gt = np.mean(np.abs(gt_v - t_gt))
    t_pred = np.median(pred_v)
    s_pred = np.mean(np.abs(pred_v - t_pred))
    aligned = (pred_depths - t_pred) * (s_gt / s_pred) + t_gt
    return aligned, t_gt, s_gt, t_pred, s_pred


def compute_scale_and_shift(prediction, target, mask=None, scale_only=False):
    """Closed-form least-squares (s, t) with s*prediction+t ≈ target."""
    prediction = np.asarray(prediction, np.float32)
    target = np.asarray(target, np.float32)
    m = np.ones_like(prediction) if mask is None else np.asarray(mask, np.float32)
    a00 = np.sum(m * prediction * prediction)
    a01 = np.sum(m * prediction)
    a11 = np.sum(m)
    b0 = np.sum(m * prediction * target)
    if scale_only:
        return b0 / (a00 + 1e-6), 0.0
    b1 = np.sum(m * target)
    det = a00 * a11 - a01 * a01
    if det == 0:
        return 1.0, 0.0
    return (a11 * b0 - a01 * b1) / det, (-a01 * b0 + a00 * b1) / det


def interpolate_frames(pre_frames, post_frames):
    """Linear cross-fade across the overlap (utils/util.py:65-74)."""
    n = len(pre_frames)
    assert n == len(post_frames)
    weights = np.linspace(0.0, 1.0, n)
    return [pre_frames[i] * (1 - weights[i]) + post_frames[i] * weights[i] for i in range(n)]


# ----------------------------------------------------------------- pose

def dump_xyz(transforms):
    """Accumulate camera positions along a chain of relative transforms."""
    xyzs = []
    cam_to_world = np.eye(4)
    xyzs.append(cam_to_world[:3, 3].copy())
    for t in transforms:
        cam_to_world = cam_to_world @ t
        xyzs.append(cam_to_world[:3, 3].copy())
    return xyzs


def dump_r(transforms):
    rs = []
    cam_to_world = np.eye(4)
    rs.append(cam_to_world[:3, :3].copy())
    for t in transforms:
        cam_to_world = cam_to_world @ t
        rs.append(cam_to_world[:3, :3].copy())
    return rs


def dump_poses(transforms):
    """Full 4x4 accumulation with left-composition (utils/utils.py:210-217)."""
    ms = []
    cam_to_world = np.eye(4)
    ms.append(cam_to_world.copy())
    for t in transforms:
        cam_to_world = t @ cam_to_world
        ms.append(cam_to_world.copy())
    return ms


def compute_ate(gtruth_xyz, pred_xyz):
    """Scale-aligned absolute trajectory error on a snippet."""
    offset = gtruth_xyz[0] - pred_xyz[0]
    pred = pred_xyz + offset[None, :]
    scale = np.sum(gtruth_xyz * pred) / np.sum(pred ** 2)
    return np.sqrt(np.sum((pred * scale - gtruth_xyz) ** 2)) / gtruth_xyz.shape[0]


def compute_re(gtruth_r, pred_r):
    """Mean rotation angle of the residual rotations."""
    total = 0.0
    for gt_pose, pred_pose in zip(gtruth_r, pred_r):
        residual = gt_pose @ np.linalg.inv(pred_pose)
        s = np.linalg.norm(
            [residual[0, 1] - residual[1, 0], residual[1, 2] - residual[2, 1], residual[0, 2] - residual[2, 0]]
        )
        c = np.trace(residual) - 1
        total += np.arctan2(s, c)
    return total / len(gtruth_r)


def compute_pose_scale(gtruth, pred):
    """Trajectory scale factor for visualization (utils/utils.py:220-224)."""
    return np.sum(gtruth[:, :3, 3] * pred[:, :3, 3]) / np.sum(pred[:, :3, 3] ** 2)
