"""Sliding-window full-video depth inference on one device.

Port of the window path of `endodav_tpu/eval/video_inference.py:
infer_video_depth` with the host stitch.  Every window's 32 source-frame
indices are known up front (`window_indices` resolves the reference's
keyframe-carry recurrence), so windows batch `chunk_windows` at a time;
only the scale/shift stitch runs sequentially, on the host.

Frames upload once from pinned host memory as their own dtype (uint8
rides 4x smaller than f32), are scaled to [0, 1] and bicubic-resized to
the keep-aspect size on the device; the model's own bilinear
`preprocess` then takes them to ``image_shape``.  The two resizes stay
separate, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from endodav_tpu_torch.eval.metrics import compute_scale_and_shift, interpolate_frames
from endodav_tpu_torch.models.endodav import INFER_LEN, INTERP_LEN, KEYFRAMES, OVERLAP
from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["keep_aspect_size", "window_indices", "stitch_plan", "infer_video_depth"]


def keep_aspect_size(h: int, w: int, target_h: int, target_w: int, multiple: int = 14):
    """lower_bound keep-aspect target size, multiple-of-14."""
    scale = max(target_w / w, target_h / h)

    def constrain(x, min_val):
        y = round(x / multiple) * multiple
        if y < min_val:
            y = math.ceil(x / multiple) * multiple
        return int(y)

    return constrain(scale * h, target_h), constrain(scale * w, target_w)


def window_indices(n_frames: int) -> np.ndarray:
    """[num_windows, INFER_LEN] source-frame index per window slot.

    Window 0 reads frames [0..31]; window k's first OVERLAP slots replay
    window k-1's KEYFRAMES slots and the rest read fresh frames.  Frames
    past the end are clamped to the last frame.
    """
    step = INFER_LEN - OVERLAP
    starts = list(range(0, n_frames, step))
    idx = np.zeros((len(starts), INFER_LEN), dtype=np.int64)
    kf = np.asarray(KEYFRAMES, dtype=np.int64)
    for wi, s in enumerate(starts):
        idx[wi] = np.clip(np.arange(s, s + INFER_LEN), 0, n_frames - 1)
        if wi > 0:
            idx[wi, :OVERLAP] = idx[wi - 1, kf]
    return idx


def _stitch(depth_windows: np.ndarray, n_frames: int) -> np.ndarray:
    """Sequential scale/shift stitch + overlap cross-fade.

    depth_windows: [num_windows, INFER_LEN, H, W] raw per-window output.
    Returns [n_frames, H, W].
    """
    align_len = OVERLAP - INTERP_LEN
    aligned: list[np.ndarray] = []
    for wi in range(depth_windows.shape[0]):
        win = depth_windows[wi]
        if wi == 0:
            aligned.extend(win)
            continue
        pre = aligned[-INTERP_LEN:]
        post = [win[i] for i in range(align_len, OVERLAP)]
        scale, shift = compute_scale_and_shift(np.concatenate(post), np.concatenate(pre))
        post = [np.maximum(f * scale + shift, 0.0) for f in post]
        aligned[-INTERP_LEN:] = interpolate_frames(pre, post)
        for i in range(OVERLAP, INFER_LEN):
            aligned.append(np.maximum(win[i] * scale + shift, 0.0))
    return np.stack(aligned[:n_frames], axis=0)


def stitch_plan(n_frames: int, num_windows: int):
    """Static output-frame ownership for the stitched video: each output
    frame blends at most two (window, slot) predictions; returns
    (win_a, slot_a, win_b, slot_b, weight_b), each [n_frames]."""
    step = INFER_LEN - OVERLAP
    win_a = np.zeros(n_frames, np.int32)
    slot_a = np.zeros(n_frames, np.int32)
    wgt_b = np.zeros(n_frames, np.float32)
    win_b = np.zeros(n_frames, np.int32)
    slot_b = np.zeros(n_frames, np.int32)
    fade = np.linspace(0.0, 1.0, INTERP_LEN)
    for f in range(n_frames):
        k = 0
        for kk in range(num_windows - 1, 0, -1):
            if f >= step * kk + OVERLAP:
                k = kk
                break
        in_fade = False
        for kk in range(1, num_windows):
            z0 = step * kk + (OVERLAP - INTERP_LEN)
            if z0 <= f < z0 + INTERP_LEN:
                win_a[f], slot_a[f] = kk - 1, f - step * (kk - 1)
                win_b[f], slot_b[f] = kk, f - step * kk
                wgt_b[f] = fade[f - z0]
                in_fade = True
                break
        if not in_fade:
            win_a[f], slot_a[f] = k, f - step * k
    return win_a, slot_a, win_b, slot_b, wgt_b


def infer_video_depth(
    forward_windows: Callable[[torch.Tensor], torch.Tensor],
    frames: np.ndarray,
    image_shape: tuple[int, int] = (224, 280),
    chunk_windows: int = 2,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Full-video sigmoid-disparity inference.

    forward_windows: [C, INFER_LEN, h, w, 3] -> [C*INFER_LEN, h', w', 1]
      (the EndoDAV forward returning ("disp", 0)).
    frames: [N, H, W, 3] uint8, or float in [0, 255] or [0, 1].
    Returns the stitched raw disparity [N, H, W] at source resolution.
    """
    device = torch.device(device)
    n, fh, fw, _ = frames.shape
    th, tw = keep_aspect_size(fh, fw, *image_shape)
    if frames.dtype == np.uint8:
        scale = 255.0
    else:
        frames = np.asarray(frames, np.float32)
        scale = 255.0 if float(frames.max()) > 1.5 else 1.0

    idx = window_indices(n)
    num_windows = idx.shape[0]
    pad_to = math.ceil(num_windows / chunk_windows) * chunk_windows
    idx_padded = np.concatenate([idx, np.repeat(idx[-1:], pad_to - num_windows, axis=0)])

    with torch.inference_mode():
        src = torch.from_numpy(np.ascontiguousarray(frames))
        if device.type == "cuda":
            src = src.pin_memory()
        resized = torch.empty((n, th, tw, 3), dtype=torch.float32, device=device)
        for s0 in range(0, n, INFER_LEN):
            slab = src[s0:s0 + INFER_LEN].to(device, non_blocking=True).float()
            if scale != 1.0:
                slab = slab / scale
            resized[s0:s0 + INFER_LEN] = resize2d(slab, (th, tw), "bicubic", align_corners=False)

        outs = []
        for c0 in range(0, pad_to, chunk_windows):
            w_idx = torch.from_numpy(idx_padded[c0:c0 + chunk_windows].reshape(-1)).to(device)
            win = resized.index_select(0, w_idx).reshape(chunk_windows, INFER_LEN, th, tw, 3)
            disp = forward_windows(win)
            disp = resize2d(disp, (fh, fw), "bilinear", align_corners=True)[..., 0]
            outs.append(disp.float().cpu())
    depth_windows = torch.cat(outs).numpy()[: num_windows * INFER_LEN]
    return _stitch(depth_windows.reshape(num_windows, INFER_LEN, fh, fw), n)
