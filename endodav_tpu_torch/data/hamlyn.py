"""Hamlyn loaders.

Port of `endodav_tpu/data/hamlyn.py`:
  * `HamlynVideos` (:37-80): whole sequences, ``image01/*.{png,jpg}``
    frames and ``depth01/*`` depths (16-bit PNG or .npy) in numeric order,
    the ``pred_root`` re-eval mode (saved ``<pred_root>/<seq>/depth/*.npy``
    beside the ground truth) and ``max_length`` truncation;
  * `HamlynFrames` (:82-115): every ``rectified*`` directory's
    ``image01/*.jpg`` frames with a matching ``depth01/*.png`` depth;
    sequences above 13 are cropped to the box (180, 0, 590, 288), and the
    frame is resized on the host (`data/pipeline.py:resize_frames`).
PNG depths are read through PIL: the raw values are the depth.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from endodav_tpu_torch.data import pipeline, readers

__all__ = ["HamlynVideos", "HamlynFrames"]


def _read_depth_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img).astype(np.float32)


def _sorted_images(d: str, max_length=None):
    files = [f for f in sorted(os.listdir(d), key=lambda x: int(os.path.splitext(x)[0]))
             if f.lower().endswith((".png", ".jpg"))]
    if max_length is not None:
        files = files[:max_length]
    return [os.path.join(d, f) for f in files]


class HamlynVideos:
    """Item: {"colors" [N, H, W, 3] uint8, "depths" [N, H, W] f32,
    "filename"}, or in re-eval mode {"depths", "pred_depths", "filename"}."""

    def __init__(self, data_path: str, filenames: list[str], pred_root: str | None = None,
                 max_length: int | None = None):
        self.data_path = data_path
        self.filenames = filenames
        self.pred_root = pred_root
        self.max_length = max_length

    def __len__(self):
        return len(self.filenames)

    def _depths(self, seq_dir: str) -> np.ndarray:
        files = sorted(os.listdir(seq_dir))
        if self.max_length is not None:
            files = files[:self.max_length]
        out = []
        for f in files:
            p = os.path.join(seq_dir, f)
            if f.endswith(".png"):
                out.append(_read_depth_png(p))
            elif f.endswith(".npy"):
                out.append(np.load(p).astype(np.float32))
        return np.stack(out, axis=0)

    def __getitem__(self, index: int) -> dict:
        filename = self.filenames[index]
        kd = os.path.join(self.data_path, filename)
        depths = self._depths(os.path.join(kd, "depth01"))
        if self.pred_root is not None:
            preds = self._depths(os.path.join(self.pred_root, filename, "depth"))
            if len(depths) != len(preds):
                raise ValueError(f"{filename}: {len(depths)} depths, {len(preds)} predictions")
            return {"depths": depths, "pred_depths": preds, "filename": filename}
        colors = np.stack([readers.read_image(p) for p in
                           _sorted_images(os.path.join(kd, "image01"), self.max_length)])
        if len(colors) != len(depths):
            raise ValueError(f"{filename}: {len(colors)} frames, {len(depths)} depths")
        return {"colors": colors, "depths": depths, "filename": filename}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


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
