"""SCARED whole-sequence eval loader (port of
`endodav_tpu/data/scared.py:ScaredVideos`, including the `pred_root`
re-eval mode)."""

from __future__ import annotations

import glob
import os

import numpy as np

from endodav_tpu_torch.data import readers
from endodav_tpu_torch.data.pipeline import pixel_intrinsics

__all__ = ["ScaredVideos"]


class ScaredVideos:
    """Whole-sequence eval loader; yields dicts of full sequences."""

    def __init__(self, data_path: str, filenames: list[str], pred_root: str | None = None):
        self.data_path = data_path
        self.filenames = filenames
        self.pred_root = pred_root

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index: int) -> dict:
        filename = self.filenames[index]
        if self.pred_root is not None:
            kd = os.path.join(self.data_path, filename)
            depth_paths = readers.list_frames(kd)["depth"]
            if not depth_paths:
                raise FileNotFoundError(f"no GT depth found under {kd}/data/scene_points")
            depths = np.stack([readers.read_scared_depth(p) for p in depth_paths], axis=0)
            pred_dir = os.path.join(self.pred_root, filename, "depth")
            pred_paths = sorted(glob.glob(os.path.join(pred_dir, "*.npy")))
            if not pred_paths:
                raise FileNotFoundError(f"no prediction .npy files under {pred_dir}")
            preds = np.stack([np.load(p).astype(np.float32) for p in pred_paths], axis=0)
            return {"depths": depths, "pred_depths": preds, "filename": filename}
        colors, depths, poses = readers.read_sequence(self.data_path, filename)
        h, w = colors.shape[1:3]
        return {"colors": colors, "depths": depths, "poses": poses,
                "Ks": pixel_intrinsics(len(colors), h, w), "filename": filename}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
