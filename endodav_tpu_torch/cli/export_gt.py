"""Ground-truth export of SCARED depths and poses into the split directory.

Port of `endodav_tpu/cli/export_gt.py` (export_gt_depth.py /
export_gt_pose.py parity), on the host: ``--what depth`` packs the
``scene_points*.tiff`` depths (channel 0, rows 0:1024) of the split's
``test_files.txt`` (``--useage eval``, to ``gt_depths.npz``) or
``3d_reconstruction.txt`` (``3d_recon``, to ``gt_depths_recon.npz``);
``--what pose`` writes ``curve/gt_poses_sequence{N}.npz``, the relative
pose ``P_f @ pinv(P_{f-1})`` of each line of ``test_files_sequence{N}.txt``.
The split directory is `eval/engine.py:splits_dir` (``ENDODAV_TPU_SPLITS_DIR``).

    python -m endodav_tpu_torch.cli.export_gt --data_path <scared> --what both
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from endodav_tpu_torch.data.readers import read_pose_json, read_scared_depth, readlines
from endodav_tpu_torch.eval.engine import splits_dir

__all__ = ["export_gt_depth", "export_gt_pose", "main"]


def _split_prefix(folder: str) -> str:
    return "train" if int(folder[7]) < 8 else "test"


def export_gt_depth(data_path: str, split: str, useage: str = "eval"):
    """The tiff index is the split line's frame_id minus one (export_gt_depth.py:63:
    endovis frame lines are 1-based against the scene_points numbering)."""
    if useage == "eval":
        lines = readlines(os.path.join(splits_dir(), split, "test_files.txt"))
        out = os.path.join(splits_dir(), split, "gt_depths.npz")
    else:
        lines = readlines(os.path.join(splits_dir(), split, "3d_reconstruction.txt"))
        out = os.path.join(splits_dir(), split, "gt_depths_recon.npz")
    gt_depths = []
    for line in lines:
        parts = line.split()
        folder, frame_index = parts[0], int(parts[1])
        path = os.path.join(data_path, _split_prefix(folder), folder, "data",
                            "scene_points", f"scene_points{frame_index - 1:06d}.tiff")
        gt_depths.append(read_scared_depth(path).astype(np.float32))
    np.savez_compressed(out, data=np.stack(gt_depths, axis=0))
    print(f"saved {len(gt_depths)} gt depths to {out}")


def export_gt_pose(data_path: str, split: str, sequence: int):
    """One relative pose a split line, between frame_id-1 and frame_id
    (export_gt_pose.py:38-57: one frame off the pairs the pose network is
    scored on, a reference quirk kept)."""
    lines = readlines(os.path.join(splits_dir(), split, f"test_files_sequence{sequence}.txt"))
    gt_local = []
    for line in lines:
        parts = line.split()
        folder, frame_index = parts[0], int(parts[1])

        def pose_at(f):
            return read_pose_json(os.path.join(data_path, _split_prefix(folder), folder, "data",
                                               "frame_data", f"frame_data{f:06d}.json"))

        p0, p1 = pose_at(frame_index - 1), pose_at(frame_index)
        gt_local.append((p1 @ np.linalg.pinv(p0)).astype(np.float32))
    out_dir = os.path.join(splits_dir(), split, "curve")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"gt_poses_sequence{sequence}.npz")
    np.savez_compressed(out, data=np.array(gt_local))
    print(f"saved {len(gt_local)} relative poses to {out}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="endovis")
    p.add_argument("--what", choices=["depth", "pose", "both"], default="both")
    p.add_argument("--useage", choices=["eval", "3d_recon"], default="eval")
    p.add_argument("--sequences", nargs="*", type=int, default=[1, 2])
    args = p.parse_args(argv)
    if args.what in ("depth", "both"):
        export_gt_depth(args.data_path, args.split, args.useage)
    if args.what in ("pose", "both"):
        for seq in args.sequences:
            export_gt_pose(args.data_path, args.split, seq)


if __name__ == "__main__":
    main()
