"""Host-side file readers for SCARED sequences.

A numpy copy of `endodav_tpu/data/readers.py` without the native C++
decoder (that module imports through the jax-bound package): PNG/JPEG
frames through PIL, float-TIFF depth (channel 0, rows 0:1024) through
cv2, w2c poses from per-frame JSON.  PIL and cv2 are imported only when a
file of their kind is read.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["read_image", "read_scared_depth", "read_pose_json", "read_sequence",
           "list_frames", "readlines"]


def readlines(path: str) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3]."""
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            return np.asarray(img.convert("RGB"))


def read_scared_depth(path: str) -> np.ndarray:
    """SCARED scene_points tiff -> float32 depth [1024, W] (channel 0)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import cv2

    d = cv2.imread(path, 3)
    if d is None:
        raise IOError(f"cv2 could not read {path}")
    return d.astype(np.float32)[0:1024, :, 0]


def read_pose_json(path: str) -> np.ndarray:
    """Per-frame w2c camera pose [4, 4]."""
    with open(path) as f:
        return np.asarray(json.load(f)["camera-pose"], dtype=np.float64)


def _sorted_files(d: str, exts: tuple[str, ...]) -> list[str]:
    names = [n for n in os.listdir(d) if n.endswith(exts)]

    def key(n):
        stem = os.path.splitext(n)[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)

    return [os.path.join(d, n) for n in sorted(names, key=key)]


def list_frames(keyframe_dir: str) -> dict[str, list[str]]:
    """Paths for one SCARED keyframe dir (data/{left,right,scene_points,frame_data})."""
    data = os.path.join(keyframe_dir, "data")
    out = {}
    for name, sub, exts in [
        ("left", "left", (".png", ".jpg")),
        ("right", "right", (".png", ".jpg")),
        ("depth", "scene_points", (".tiff", ".npy")),
        ("pose", "frame_data", (".json",)),
    ]:
        d = os.path.join(data, sub)
        out[name] = _sorted_files(d, exts) if os.path.isdir(d) else []
    return out


def read_sequence(data_path: str, filename: str):
    """Whole-sequence RAM load for eval.

    Returns (colors [N,H,W,3] uint8, depths [N,H,W] f32, poses [N,4,4])."""
    paths = list_frames(os.path.join(data_path, filename))
    if not paths["left"]:
        raise FileNotFoundError(
            f"no frames found under {os.path.join(data_path, filename)}/data/left — "
            "check --data_path and the split file")
    colors = np.stack([read_image(p) for p in paths["left"]], axis=0)
    depths = np.stack([read_scared_depth(p) for p in paths["depth"]], axis=0)
    poses = np.stack([read_pose_json(p) for p in paths["pose"]], axis=0)
    if not len(colors) == len(depths) == len(poses):
        raise ValueError(f"{filename}: {len(colors)} frames, {len(depths)} depths, "
                         f"{len(poses)} poses")
    return colors, depths, poses
