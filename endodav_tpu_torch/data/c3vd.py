"""C3VD colonoscopy frame-level eval set.

Port of `endodav_tpu/data/c3vd.py`: ``<seq>/<frame>_color.png`` frames
with their ``<frame>_depth.tiff`` (16-bit, read through cv2 and rescaled
by 100/65535), both cropped to the box (200, 180, 1150, 900); the frame
is resized on the host (`data/pipeline.py:resize_frames`).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from endodav_tpu_torch.data import pipeline, readers

__all__ = ["C3VDFrames"]


class C3VDFrames:
    BOX = (200, 180, 1150, 900)  # (left, top, right, bottom)
    RESCALE = 100.0 / 65535.0

    def __init__(self, data_path: str, height: int, width: int):
        self.height = height
        self.width = width
        self.scans = []
        for vdir in sorted(os.path.join(data_path, f) for f in os.listdir(data_path)):
            for img_path in sorted(glob.glob(os.path.join(vdir, "*_color.png"))):
                stem = os.path.basename(img_path)[: -len("_color.png")]
                depth_path = os.path.join(vdir, stem + "_depth.tiff")
                if os.path.exists(depth_path):
                    self.scans.append({"image": img_path, "depth": depth_path,
                                       "sequence": os.path.basename(vdir)})

    def __len__(self):
        return len(self.scans)

    def _read_depth(self, path: str) -> np.ndarray:
        import cv2

        d = cv2.imread(path, 3)
        if d is None:
            raise IOError(f"cv2 could not read {path}")
        return d[:, :, 0].astype(np.float32) * self.RESCALE

    def __getitem__(self, index: int) -> dict:
        scan = self.scans[index]
        img = readers.read_image(scan["image"]).astype(np.float32) / 255.0
        depth = self._read_depth(scan["depth"])
        l, t, r, b = self.BOX
        img = img[t:b, l:r]
        depth = depth[t:b, l:r]
        img = pipeline.resize_frames(img[None], (self.height, self.width))[0]
        return {("color", 0, 0): img, "depth_gt": depth[..., None], "sequence": scan["sequence"]}
