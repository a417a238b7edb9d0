"""Odometry benchmark on the endovis pose sequences, served by the port.

Port of `endodav_tpu/cli/evaluate_pose.py` (evaluate_pose.py:73-239
parity): for sequences 1 and 2, the frame pairs of
``splits/<split>/test_files_sequence{N}.txt`` (`ScaredFrames`, frames 0
and 1 of each line at ``--height`` x ``--width``) through the pose encoder,
pose decoder and intrinsics head of ``--load_weights_folder`` on the card
(`eval/engine.py:evaluate_pose_pairs`), ATE and RE on 5-frame tracks
against ``splits/<split>/curve/gt_poses_sequence{N}.npz`` (`cli/export_gt`;
``endovis_old`` where ``<split>`` lacks a file) with the 95% CI, the
normalised intrinsics' mean and spread under ``--learn_intrinsics``; the
predicted poses go to ``curve/pred_poses_sequence{N}.npz`` and the lines
are appended to ``<load_weights_folder>/pose_eval.txt``.  The split
directory is `eval/engine.py:splits_dir` (``ENDODAV_TPU_SPLITS_DIR``).

    python -m endodav_tpu_torch.cli.evaluate_pose --data_path <scared> \
        --load_weights_folder <weights> --eval_mono
"""

from __future__ import annotations

import os

import numpy as np

from endodav_tpu_torch.data.readers import readlines
from endodav_tpu_torch.data.scared import ScaredFrames
from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.options import EndoDAVOptions
from endodav_tpu_torch.utils.precision import set_f32_policy


def sequence_pairs(opt, filenames) -> np.ndarray:
    """[N, H, W, 6] (frame 1, frame 0) of each split line."""
    ds = ScaredFrames(opt.data_path, filenames, opt.height, opt.width, frame_idxs=(0, 1))
    pairs = []
    for i in range(len(ds)):
        item = ds[i]
        pairs.append(np.concatenate([item[("color", 1, 0)], item[("color", 0, 0)]], axis=-1))
    return np.stack(pairs)


def _split_file(split: str, *parts: str) -> str:
    """``<splits>/<split>/...``, else the same file under ``endovis_old``."""
    path = os.path.join(engine.splits_dir(), split, *parts)
    return path if os.path.exists(path) else os.path.join(engine.splits_dir(), "endovis_old",
                                                          *parts)


def evaluate(opt, split: str = "endovis"):
    device = engine.resolve_device(opt)
    set_f32_policy()
    results, all_intr, out_lines = {}, [], []
    for seq in (1, 2):
        filenames = readlines(_split_file(split, f"test_files_sequence{seq}.txt"))
        gt_path = _split_file(split, "curve", f"gt_poses_sequence{seq}.npz")
        if not os.path.exists(gt_path):
            print(f"[evaluate_pose] missing GT poses {gt_path}; run export_gt_pose first")
            continue
        gt_local = np.load(gt_path, fix_imports=True, encoding="latin1")["data"]
        # evaluate_pose.py:183-190: gt_count-1 track windows
        res = engine.evaluate_pose_pairs(opt, gt_local, sequence_pairs(opt, filenames),
                                         num_tracks=gt_local.shape[0] - 1, device=device)
        results[seq] = res
        all_intr.append(res["pred_intrinsics"])
        out_dir = os.path.join(engine.splits_dir(), split, "curve")
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(os.path.join(out_dir, f"pred_poses_sequence{seq}.npz"),
                            data=res["pred_poses"])
        out_lines.append(
            f"sq{seq} Trajectory error: {res['ate_mean']:.4f}, std: {res['ate_std']:.4f}, "
            f"95% cls: [{res['ate_ci'][0]:.4f}, {res['ate_ci'][1]:.4f}]")
        out_lines.append(f"sq{seq} Rotation error: {res['re_mean']:.4f}, std: {res['re_std']:.4f}")

    for line in out_lines:
        print(line)
    if opt.learn_intrinsics and all_intr:
        intr = np.concatenate(all_intr, axis=0)
        for label, row, col, norm in (("fx", 0, 0, opt.width), ("fy", 1, 1, opt.height),
                                      ("cx", 0, 2, opt.width), ("cy", 1, 2, opt.height)):
            print(f"{label}: {intr[:, row, col].mean() / norm:.4f}, "
                  f"std: {intr[:, row, col].std() / norm:.4f}")
    if opt.load_weights_folder:
        with open(os.path.join(os.path.expanduser(opt.load_weights_folder), "pose_eval.txt"),
                  "a") as f:
            f.write("\n".join(out_lines) + "\n")
    return results


def main(argv=None):
    return evaluate(EndoDAVOptions().parse(argv))


if __name__ == "__main__":
    main()
