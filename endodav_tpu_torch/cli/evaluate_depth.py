"""Single-frame depth eval, served by the port.

Run as ``python -m endodav_tpu_torch.cli.evaluate_depth --model_type endodac
--eval_split {endovis,hamlyn,c3vd} --data_path <tree> [flags]`` (add
``--no_cuda`` for the CPU).  Port of `endodav_tpu/cli/evaluate_depth.py`:
the SCARED ``endovis`` split against the exported ``gt_depths.npz`` of the
split directory (`engine.splits_dir`), Hamlyn and C3VD against their own
depths; median scaling unless ``--disable_median_scaling``;
``--ext_disp_to_eval`` evaluates an .npy of already-scaled disparities
instead of a model.  Prints the same lines as JAX's CLI.

``--post_process`` runs every image a second time, flipped, and keeps the
unflipped result, as the reference does (its blend is never called);
``--post_process_blend`` applies the Monodepth-v1 blend of the two.  ``--serve_mesh model=N``
serves EndoDAC through the tensor-parallel trunk over N ranks, which the
CLI starts; ``data=N`` runs the whole eval on each of N ranks (JAX's
single-frame path ignores it).  Rank 0 alone prints and writes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from endodav_tpu_torch.data.c3vd import C3VDFrames
from endodav_tpu_torch.data.hamlyn import HamlynFrames
from endodav_tpu_torch.data.readers import readlines
from endodav_tpu_torch.data.scared import ScaredFrames
from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.eval import metrics as M
from endodav_tpu_torch.geometry.transforms import disp_to_depth
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.options import EndoDAVOptions
from endodav_tpu_torch.parallel import is_main, run_cli

HEADER = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
BATCH = 8


def _dataset(opt):
    """(frame dataset, exported gt depths or None) of ``opt.eval_split``."""
    if opt.eval_split in ("endovis", "scared_video"):
        split = os.path.join(engine.splits_dir(), "endovis")
        dataset = ScaredFrames(opt.data_path, readlines(os.path.join(split, "test_files.txt")),
                               opt.height, opt.width, frame_idxs=(0,))
        gt_path = os.path.join(split, "gt_depths.npz")
        gt = (np.load(gt_path, fix_imports=True, encoding="latin1")["data"]
              if os.path.exists(gt_path) else None)
        return dataset, gt
    if opt.eval_split == "hamlyn":
        return HamlynFrames(opt.data_path, opt.height, opt.width), None
    if opt.eval_split == "c3vd":
        return C3VDFrames(opt.data_path, opt.height, opt.width), None
    raise ValueError(opt.eval_split)


def blend_flipped(l_disp: np.ndarray, r_disp: np.ndarray) -> np.ndarray:
    """Monodepth-v1's per-row blend of a disparity [N, H, W] and the one of
    the flipped image, flipped back."""
    _, hh, ww = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    ll, _ = np.meshgrid(np.linspace(0, 1, ww), np.linspace(0, 1, hh))
    l_mask = (1.0 - np.clip(20 * (ll - 0.05), 0, 1))[None]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def model_disparities(opt, imgs: np.ndarray, device) -> tuple[np.ndarray, float]:
    """The model's disparity [N, h', w'] of images [N, H, W, 3] in [0, 1]
    (with ``--post_process[_blend]`` the flipped pass too), in batches of
    BATCH on ``device``, the last at its own size; and the ms per image."""
    fwd = engine.depth_window_forward(engine.build_depth_model(opt, device), opt)
    n_real = len(imgs)
    flipped = opt.post_process or opt.post_process_blend
    if flipped:
        imgs = np.concatenate([imgs, imgs[:, :, ::-1]], axis=0)
    t0 = time.perf_counter()
    outs = [fwd(torch.from_numpy(np.ascontiguousarray(imgs[c0:c0 + BATCH])).to(device))[..., 0]
            for c0 in range(0, len(imgs), BATCH)]
    disps = torch.cat(outs).float().cpu().numpy()
    ms = (time.perf_counter() - t0) / n_real * 1000
    if opt.post_process_blend:
        return blend_flipped(disps[:n_real], disps[n_real:, :, ::-1]), ms
    return (disps[:n_real] if flipped else disps), ms


def evaluate(opt):
    """The mean of the seven depth errors over the valid frames (None when
    every frame's gt mask is empty)."""
    max_depth = 100.0 if opt.eval_split == "c3vd" else 150.0
    dataset, gt_depths = _dataset(opt)
    items = [dataset[i] for i in range(len(dataset))]
    pred_disps, times = None, []
    if opt.ext_disp_to_eval:
        pred_disps = np.load(opt.ext_disp_to_eval)
    else:
        imgs = np.stack([it[("color", 0, 0)] for it in items]).astype(np.float32)
        model_disps, ms = model_disparities(opt, imgs, engine.resolve_device(opt))
        times.append(ms)

    errors, ratios, saved_disps = [], [], []
    for i, item in enumerate(items):
        # endovis: the exported gt; hamlyn and c3vd: the dataset's depth
        if gt_depths is not None:
            gt = gt_depths[i]
        elif "depth_gt" in item:
            gt = item["depth_gt"][..., 0]
        else:
            continue
        disp = pred_disps[i] if pred_disps is not None else model_disps[i]
        # the reference's cv2.resize (half-pixel sampling) before inverting
        disp = resize2d(torch.from_numpy(np.ascontiguousarray(disp[None, ..., None],
                                                              dtype=np.float32)),
                        gt.shape[:2], "bilinear", align_corners=False)[0, ..., 0].numpy()
        saved_disps.append(disp)
        # an external file holds scaled disparity; the model's is scaled
        # here (the affine scaling commutes with the bilinear resize)
        scaled = disp if pred_disps is not None else disp_to_depth(disp, opt.min_depth,
                                                                   opt.max_depth)[0]
        pred = 1.0 / scaled
        mask = (gt > 1e-3) & (gt < max_depth)
        if mask.sum() == 0:
            continue
        pred = pred * opt.pred_depth_scale_factor
        if not opt.disable_median_scaling:
            ratio = np.median(gt[mask]) / np.median(pred[mask])
            ratios.append(ratio)
            pred = pred * ratio
        pred = np.clip(pred, 1e-3, max_depth)
        errors.append(M.compute_errors(gt, pred, mask))

    if opt.save_pred_disps and pred_disps is None and opt.load_weights_folder and is_main():
        out = os.path.join(os.path.expanduser(opt.load_weights_folder),
                           f"disps_{opt.eval_split}_split.npy")
        np.save(out, np.array(saved_disps, dtype=object), allow_pickle=True)
        print(f"saved predicted disparities to {out}")

    if not errors:
        print("no valid frames: every gt mask was empty "
              f"(gt must contain values in (1e-3, {max_depth}))")
        return None
    errors = np.array(errors)
    mean_errors = errors.mean(0)
    engine.print_alignment_summary("scale", ratios)
    print(" | ".join(f"{n}={v:.4f}" for n, v in zip(HEADER, mean_errors)))
    engine.print_ci_row(errors)
    if times:
        print(f"average inference time: {np.mean(times):.2f} ms/frame")
    return mean_errors


def main(args=None):
    return run_cli(evaluate, EndoDAVOptions().parse(args), training=False)


if __name__ == "__main__":
    main()
