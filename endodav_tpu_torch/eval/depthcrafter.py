"""DepthCrafter-protocol batch scorer, on the host.

Port of `endodav_tpu/eval/depthcrafter.py` (utils/depthcrafter_eval/
parity): disparity predictions scored against ground-truth depth after a
least-squares scale and shift in the disparity domain, per frame or one
fit for the whole clip (``temporal_fit``; eval_utils.py:155-262), with the
standard depth metrics, TAE/TAS where the camera matrices are given, and
csv and json reports.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from endodav_tpu_torch.eval import metrics as M

__all__ = ["lstsq_disparity_alignment", "score_batch", "write_reports"]


def lstsq_disparity_alignment(pred_disp, gt_depth, mask, temporal_fit: bool = False):
    """Fit scale/shift mapping predicted disparity to 1/gt in the masked
    region; per-frame by default, one global fit when temporal_fit."""
    pred = pred_disp.astype(np.float64)
    inv_gt = 1.0 / np.clip(gt_depth, 1e-6, None)

    def fit(p, t):
        A = np.stack([p, np.ones_like(p)], axis=-1)
        x, *_ = np.linalg.lstsq(A, t, rcond=None)
        return x[0], x[1]

    out = pred.copy()
    if temporal_fit:
        s, t = fit(pred[mask].ravel(), inv_gt[mask].ravel())
        out = pred * s + t
    else:
        for f in range(pred.shape[0]):
            if mask[f].sum() == 0:
                continue
            s, t = fit(pred[f][mask[f]].ravel(), inv_gt[f][mask[f]].ravel())
            out[f] = pred[f] * s + t
    return out


def score_batch(pred_disp, gt_depth, mask=None, depth_range=(0.1, 150.0),
                img2lidar=None, temporal_fit: bool = False,
                eval_metrics=("abs_rel", "rmse", "d1")):
    """[N, H, W] disparity predictions -> metric dict (with ``num_sample``)."""
    if mask is None:
        mask = (gt_depth > depth_range[0]) & (gt_depth < depth_range[1])
    aligned = lstsq_disparity_alignment(pred_disp, gt_depth, mask, temporal_fit)
    depth = np.clip(1.0 / np.clip(aligned, 1e-6, None), *depth_range)

    fns = {
        "abs_rel": M.abs_rel,
        "sq_rel": lambda g, p: float((((g - p) ** 2) / g).mean()),
        "rmse": lambda g, p: float(np.sqrt(((g - p) ** 2).mean())),
        "rmse_log": lambda g, p: float(np.sqrt(((np.log(g) - np.log(p)) ** 2).mean())),
        "log10": M.log10,
        "silog": M.silog,
        "d1": lambda g, p: M.delta_threshold(g, p, 1),
        "d2": lambda g, p: M.delta_threshold(g, p, 2),
        "d3": lambda g, p: M.delta_threshold(g, p, 3),
    }
    result = {k: 0.0 for k in eval_metrics}
    n = 0
    for f in range(len(gt_depth)):
        if mask[f].sum() == 0:
            continue
        g, p = gt_depth[f][mask[f]], depth[f][mask[f]]
        for k in eval_metrics:
            if k not in ("tae", "tas"):
                result[k] += fns[k](g, p)
        n += 1
    for k in eval_metrics:
        if k not in ("tae", "tas"):
            result[k] /= max(n, 1)

    if img2lidar is not None and {"tae", "tas"} & set(eval_metrics):
        taes, tass = [], []
        for f in range(len(gt_depth) - 1):
            args = (depth[f], mask[f], img2lidar[f], depth[f + 1], mask[f + 1], img2lidar[f + 1])
            taes.append(M.tae(*args))
            tass.append(M.tas(*args))
        if "tae" in eval_metrics:
            result["tae"] = float(np.mean(taes))
        if "tas" in eval_metrics:
            result["tas"] = float(np.mean(tass))
    result["num_sample"] = n
    return result


def write_reports(results: dict[str, dict], out_dir: str):
    """``results.json`` and ``results.csv`` in ``out_dir`` (depthcrafter_eval/eval.py:55-120)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    keys = sorted({k for r in results.values() for k in r})
    with open(os.path.join(out_dir, "results.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sequence"] + keys)
        for name, r in results.items():
            w.writerow([name] + [r.get(k, "") for k in keys])
