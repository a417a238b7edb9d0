"""Hamlyn frame-level eval set.

Port of `endodav_tpu/data/hamlyn.py:HamlynFrames` (:82-115): every
``rectified*`` directory's ``image01/*.jpg`` frames with a matching
``depth01/*.png`` depth, read through PIL (the raw PNG values are the
depth); sequences above 13 are cropped to the box (180, 0, 590, 288).  The
frame is resized on the host (`data/pipeline.py:resize_frames`).  The
whole-sequence `HamlynVideos` is not ported.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from endodav_tpu_torch.data import pipeline, readers

__all__ = ["HamlynFrames"]


def _read_depth_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img).astype(np.float32)


class HamlynFrames:
    """Frame-level eval set; crop box (180, 0, 590, 288) for sequences > 13."""

    BOX = (180, 0, 590, 288)  # (left, top, right, bottom)

    def __init__(self, data_path: str, height: int, width: int):
        self.height = height
        self.width = width
        self.scans = []
        for rdir in sorted(os.path.join(data_path, f) for f in os.listdir(data_path)):
            for img_path in sorted(glob.glob(os.path.join(rdir, "image01", "*.jpg"))):
                name = os.path.basename(img_path)
                depth_path = os.path.join(rdir, "depth01", name[:-4] + ".png")
                if os.path.exists(depth_path):
                    self.scans.append({"image": img_path, "depth": depth_path,
                                       "sequence": int(rdir[-2:])})

    def __len__(self):
        return len(self.scans)

    def __getitem__(self, index: int) -> dict:
        scan = self.scans[index]
        img = readers.read_image(scan["image"]).astype(np.float32) / 255.0
        depth = _read_depth_png(scan["depth"])
        if scan["sequence"] > 13:
            l, t, r, b = self.BOX
            img = img[t:b, l:r]
            depth = depth[:, l:r]
        img = pipeline.resize_frames(img[None], (self.height, self.width))[0]
        return {("color", 0, 0): img, "depth_gt": depth[..., None], "sequence": scan["sequence"]}
