"""SCARED datasets: the training clip sampler and the whole-sequence eval
loader.

Port of `endodav_tpu/data/scared.py`: `ScaredVideoClips` (:30-193) in its
device-preprocess layout (the scale-0 stack, the frame-window map and the
jitter parameters; the pyramid and the jitter run on the card,
`ops/jitter.py`), and `ScaredVideos` with the `pred_root` re-eval mode.
Outputs are numpy, channels-last; batching happens in `data/loader.py`.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from endodav_tpu_torch.data import pipeline, readers
from endodav_tpu_torch.data.pipeline import pixel_intrinsics

__all__ = ["ScaredVideoClips", "ScaredVideos"]


class ScaredVideoClips:
    """Length-T training clips over all keyframe dirs of a split.

    Item ``index`` starts at frame ``index * T + randint(T)``; the clip's
    T + 2 frames (one before, one after) are loaded, flipped at random and
    resized to (height, width) on the host.  The item holds
    ``("frames_scale0",)`` [T+2, H, W, 3], ``("frame_window_map",)``
    [3, T] (rows: frame ids 0, -1, +1), ``("jitter_order",)`` [4],
    ``("jitter_factors",)`` [4] and per-scale ``("K", s)``/``("inv_K", s)``
    [T, 4, 4].  Per-item rngs keep sampling deterministic under any worker
    count.  (The host-preprocess and random_train layouts are not ported.)
    """

    def __init__(self, data_path: str, filenames: list[str], height: int, width: int,
                 frame_idxs=(0, -1, 1), num_scales: int = 4, is_train: bool = False,
                 T: int = 4, frame_max_interval: int = 1, seed: int = 314):
        if tuple(frame_idxs) != (0, -1, 1):
            raise ValueError(f"the video trainer requires frame_ids [0, -1, 1], got {frame_idxs}")
        self.height, self.width = height, width
        self.num_scales = num_scales
        self.is_train = is_train
        self.T = T
        self.frame_max_interval = frame_max_interval
        self.seed = seed
        self.epoch = 0  # bumped by the Loader so repeated indices resample
        self.frames: list[str] = []
        for filename in filenames:
            left = readers.list_frames(os.path.join(data_path, filename))["left"]
            if not left:
                raise FileNotFoundError(f"no frames under {os.path.join(data_path, filename)}")
            self.frames.extend(left)

    def __len__(self):
        n = len(self.frames)
        length = n - self.T - 2 + 1 - self.frame_max_interval * self.T
        return max(0, length // self.T)

    def _load_colors(self, indices, flip: bool) -> np.ndarray:
        frames = [readers.read_image(self.frames[i]).astype(np.float32) / 255.0 for i in indices]
        stack = np.stack(frames, axis=0)
        return stack[:, :, ::-1] if flip else stack

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, int(index), 0]))
        index = index * self.T + int(rng.integers(0, self.T))
        if self.frame_max_interval > 1:
            frame_steps = rng.integers(1, self.frame_max_interval, size=self.T + 2)
        else:
            frame_steps = np.ones(self.T + 2, dtype=np.int64)
        do_aug = self.is_train and rng.random() > 0.5
        do_flip = self.is_train and rng.random() > 0.5
        jit = pipeline.sample_color_jitter(rng) if do_aug else None

        indices = [index + fi * int(frame_steps[fi]) for fi in range(self.T + 2)]
        colors = self._load_colors(indices, do_flip)
        r = np.arange(self.T)
        inputs = {
            ("frames_scale0",): pipeline.resize_frames(colors, (self.height, self.width)),
            ("frame_window_map",): np.stack([1 + r, r, 2 + r]).astype(np.int32),
        }
        if jit is not None:
            inputs[("jitter_order",)] = np.asarray(jit["order"], np.int32)
            inputs[("jitter_factors",)] = np.asarray(
                [jit["brightness"], jit["contrast"], jit["saturation"], jit["hue"]], np.float32)
        else:
            inputs[("jitter_order",)] = np.arange(4, dtype=np.int32)
            inputs[("jitter_factors",)] = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
        for s in range(self.num_scales):
            K, inv_K = pipeline.scaled_intrinsics(self.width, self.height, s)
            inputs[("K", s)] = np.repeat(K[None], self.T, axis=0)
            inputs[("inv_K", s)] = np.repeat(inv_K[None], self.T, axis=0)
        return inputs


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
