"""SCARED datasets: the training clip sampler, the whole-sequence eval
loader and the frame-level eval set.

Port of `endodav_tpu/data/scared.py`: `ScaredVideoClips` (:30-193) in both
its layouts (device preprocessing: the scale-0 stack, the frame-window
map and the jitter parameters, the pyramid and the jitter built on the
card by `ops/jitter.py`; host: the pyramids built here, the val loader's)
and with ``random_train``, `ScaredVideos` with the `pred_root` re-eval
mode, and
`ScaredFrames` (:238-335), the ``endovis`` split of the single-frame eval
(host pyramid and jitter, `data/pipeline.py`).
Outputs are numpy, channels-last; batching happens in `data/loader.py`.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from endodav_tpu_torch.data import pipeline, readers
from endodav_tpu_torch.data.pipeline import pixel_intrinsics

__all__ = ["ScaredVideoClips", "ScaredVideos", "ScaredFrames"]


class ScaredVideoClips:
    """Length-T training and val clips over all keyframe dirs of a split.

    Item ``index`` starts at frame ``index * T + randint(T)``; the clip's
    T + 2 frames (one before, one after) are loaded and flipped at random
    (training only).  Two layouts, as JAX's:

    * ``device_preprocess``: ``("frames_scale0",)``, the stack resized to
      (height, width), ``("frame_window_map",)`` [3, T] (rows: frame ids 0,
      -1, +1), ``("jitter_order",)`` [4] and ``("jitter_factors",)`` [4];
      the pyramid and the jitter run on the card (`ops/jitter.py`).  With
      ``random_capable`` the stack is [3T] (one triplet a slot) in both
      ``random_train`` phases;
    * host (``device_preprocess=False``, the val loader's): per-frame-id
      ``("color"/"color_aug", fi, s)`` [T, ...] pyramids built on the host
      (`data/pipeline.py`), and ``"depth_gt"`` [T, H, W, 1] when not
      training and the tree has depths.  ``random_train`` samples T
      independent frames, each with its neighbours.

    Both carry per-scale ``("K", s)``/``("inv_K", s)`` [T, 4, 4].  Per-item
    rngs (seed, epoch, index, random_train) keep sampling deterministic
    under any worker count.
    """

    def __init__(self, data_path: str, filenames: list[str], height: int, width: int,
                 frame_idxs=(0, -1, 1), num_scales: int = 4, is_train: bool = False,
                 T: int = 4, frame_max_interval: int = 1, seed: int = 314,
                 device_preprocess: bool = False, random_capable: bool = False):
        if tuple(frame_idxs) != (0, -1, 1):
            raise ValueError(f"the video trainer requires frame_ids [0, -1, 1], got {frame_idxs}")
        self.height, self.width = height, width
        self.frame_idxs = tuple(frame_idxs)
        self.num_scales = num_scales
        self.is_train = is_train
        self.T = T
        self.frame_max_interval = frame_max_interval
        self.seed = seed
        self.device_preprocess = device_preprocess
        self.random_capable = random_capable
        self.random_train = False  # set by the trainer's alternation
        self.load_depth = not is_train
        self.epoch = 0  # bumped by the Loader so repeated indices resample
        self.frames: list[str] = []
        self.depths: list[str | None] = []
        for filename in filenames:
            paths = readers.list_frames(os.path.join(data_path, filename))
            if not paths["left"]:
                raise FileNotFoundError(f"no frames under {os.path.join(data_path, filename)}")
            self.frames.extend(paths["left"])
            self.depths.extend(paths["depth"] or [None] * len(paths["left"]))

    def __len__(self):
        n = len(self.frames)
        length = n - self.T - 2 + 1 - self.frame_max_interval * self.T
        return max(0, length // self.T)

    def _load_colors(self, indices, flip: bool) -> np.ndarray:
        frames = [readers.read_image(self.frames[i]).astype(np.float32) / 255.0 for i in indices]
        stack = np.stack(frames, axis=0)
        return stack[:, :, ::-1] if flip else stack

    def _random_base(self, rng) -> np.ndarray:
        """T independent centre frames of the random_train phase."""
        n = len(self.frames)
        return rng.integers(self.frame_max_interval, n - self.frame_max_interval - 1, size=self.T)

    def _device_layout(self, rng, index, frame_steps, do_flip, jit) -> dict:
        t = self.T
        if self.random_capable:
            if self.random_train:
                base = self._random_base(rng)
                steps = frame_steps[:t]
                stack_idx = np.concatenate([base, base - steps, base + steps])
            else:
                idx_all = np.asarray([index + fi * int(frame_steps[fi]) for fi in range(t + 2)])
                stack_idx = np.concatenate([idx_all[1:t + 1], idx_all[0:t], idx_all[2:t + 2]])
            wmap = np.stack([np.arange(t), t + np.arange(t), 2 * t + np.arange(t)])
        else:
            stack_idx = [index + fi * int(frame_steps[fi]) for fi in range(t + 2)]
            r = np.arange(t)
            wmap = np.stack([1 + r, r, 2 + r])
        colors = self._load_colors(stack_idx, do_flip)
        inputs = {
            ("frames_scale0",): pipeline.resize_frames(colors, (self.height, self.width)),
            ("frame_window_map",): wmap.astype(np.int32),
        }
        if jit is not None:
            inputs[("jitter_order",)] = np.asarray(jit["order"], np.int32)
            inputs[("jitter_factors",)] = np.asarray(
                [jit["brightness"], jit["contrast"], jit["saturation"], jit["hue"]], np.float32)
        else:
            inputs[("jitter_order",)] = np.arange(4, dtype=np.int32)
            inputs[("jitter_factors",)] = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
        return inputs

    def _host_layout(self, rng, index, frame_steps, do_flip, jit) -> dict:
        t, inputs = self.T, {}
        if self.random_train:
            base = self._random_base(rng)
            for fi, offs in ((0, 0), (1, frame_steps[:t]), (-1, -frame_steps[:t])):
                cs, cas = pipeline.build_pyramid(self._load_colors(base + offs, do_flip),
                                                 self.height, self.width, self.num_scales, jit)
                for s in range(self.num_scales):
                    inputs[("color", fi, s)] = cs[s]
                    inputs[("color_aug", fi, s)] = cas[s]
            indices = base
        else:
            indices_all = [index + fi * int(frame_steps[fi]) for fi in range(t + 2)]
            indices = indices_all[1:-1]
            cs, cas = pipeline.build_pyramid(self._load_colors(indices_all, do_flip),
                                             self.height, self.width, self.num_scales, jit)
            for fi in self.frame_idxs:
                for s in range(self.num_scales):
                    inputs[("color", fi, s)] = cs[s][1 + fi:t + 1 + fi].copy()
                    inputs[("color_aug", fi, s)] = cas[s][1 + fi:t + 1 + fi].copy()
        if self.load_depth and self.depths[0] is not None:
            depths = [readers.read_scared_depth(self.depths[i]) for i in indices]
            inputs["depth_gt"] = np.stack([(d[:, ::-1] if do_flip else d)[..., None]
                                           for d in depths], axis=0)
        return inputs

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, self.epoch, int(index), int(self.random_train)]))
        index = index * self.T + int(rng.integers(0, self.T))
        if self.frame_max_interval > 1:
            frame_steps = rng.integers(1, self.frame_max_interval, size=self.T + 2)
        else:
            frame_steps = np.ones(self.T + 2, dtype=np.int64)
        do_aug = self.is_train and rng.random() > 0.5
        do_flip = self.is_train and rng.random() > 0.5
        jit = pipeline.sample_color_jitter(rng) if do_aug else None
        layout = self._device_layout if self.device_preprocess else self._host_layout
        inputs = layout(rng, index, frame_steps, do_flip, jit)
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


class ScaredFrames:
    """Frame-level dataset for the endovis split (line format
    'folder frame_idx side'; path scheme mono_dataset.py:41-72)."""

    def __init__(
        self,
        data_path: str,
        filenames: list[str],
        height: int,
        width: int,
        frame_idxs=(0, -1, 1),
        num_scales: int = 4,
        is_train: bool = False,
        seed: int = 314,
    ):
        self.data_path = data_path
        self.filenames = filenames
        self.height = height
        self.width = width
        self.frame_idxs = tuple(frame_idxs)
        self.num_scales = num_scales
        self.is_train = is_train
        self.rng = np.random.default_rng(seed)
        self.side_map = {"l": "left", "r": "right"}

    def __len__(self):
        return len(self.filenames)

    @staticmethod
    def _split_prefix(folder: str) -> str:
        # dataset number < 8 lives under train/ (scared_dataset.py:44-48)
        return "train" if int(folder[7]) < 8 else "test"

    def _frame_path(self, folder: str, frame_index: int, side: str) -> str:
        return os.path.join(
            self.data_path, self._split_prefix(folder), folder, "data",
            self.side_map[side], f"{frame_index:010d}.png",
        )

    def _depth_path(self, folder: str, frame_index: int) -> str:
        return os.path.join(
            self.data_path, self._split_prefix(folder), folder, "data",
            "scene_points", f"scene_points{frame_index:06d}.tiff",
        )

    def get_pose(self, folder: str, frame_index: int) -> np.ndarray:
        """c2w pose (pinv of the stored w2c, scared_dataset.py:74-85)."""
        path = os.path.join(
            self.data_path, self._split_prefix(folder), folder, "data",
            "frame_data", f"frame_data{frame_index:06d}.json",
        )
        return np.linalg.pinv(readers.read_pose_json(path))

    def __getitem__(self, index: int) -> dict:
        rng = self.rng
        parts = self.filenames[index].split()
        folder = parts[0]
        frame_index = int(parts[1]) if len(parts) == 3 else 0
        side = parts[2] if len(parts) == 3 else "l"

        do_aug = self.is_train and rng.random() > 0.5
        do_flip = self.is_train and rng.random() > 0.5
        jit = pipeline.sample_color_jitter(rng) if do_aug else None

        inputs = {}
        for fi in self.frame_idxs:
            if fi == "s":
                path = self._frame_path(folder, frame_index, {"l": "r", "r": "l"}[side])
            else:
                path = self._frame_path(folder, frame_index + fi, side)
            img = readers.read_image(path).astype(np.float32) / 255.0
            if do_flip:
                img = img[:, ::-1]
            cs, cas = pipeline.build_pyramid(img[None], self.height, self.width, self.num_scales, jit)
            for s in range(self.num_scales):
                inputs[("color", fi, s)] = cs[s][0]
                inputs[("color_aug", fi, s)] = cas[s][0]

        if not self.is_train:
            dpath = self._depth_path(folder, frame_index)
            if os.path.exists(dpath):
                d = readers.read_scared_depth(dpath)
                if do_flip:
                    d = d[:, ::-1]
                inputs["depth_gt"] = d[..., None]

        for s in range(self.num_scales):
            K, inv_K = pipeline.scaled_intrinsics(self.width, self.height, s)
            inputs[("K", s)] = K
            inputs[("inv_K", s)] = inv_K

        if "s" in self.frame_idxs:
            stereo_T = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * baseline_sign * 0.1
            inputs["stereo_T"] = stereo_T
        return inputs
