"""Online (streaming) sliding-window video depth.

Port of `endodav_tpu/eval/streaming.py:DepthStreamer`, the live-endoscopy
path: frames arrive one at a time and depth comes back with bounded
latency and memory, equal to the offline `infer_video_depth(...,
stitch="host")` for every stream length.

* `push(frame)` takes one [H, W, 3] frame and returns the depth frames
  that became final (no later window can change them through the
  INTERP_LEN cross-fade).  Window k fires when source frame
  step*k + INFER_LEN - 1 arrives (step = INFER_LEN - OVERLAP).
* `flush()` ends the stream: the remaining windows run with the offline
  path's clamped padding (indices past the end read the last frame).

Each window's source indices are those of `window_indices`, computed
online with the keyframe carry; the scale/shift stitch runs incrementally
on the host, so only the last INTERP_LEN aligned frames are provisional.
Frames are kept only while a later window can read them (the carry
reaches two windows back): fewer than 2*INFER_LEN are buffered.

With ``dedup`` (a `DedupWindowForward`) every frame is encoded once, when
it arrives (the trunk, and in prefix mode the DPT head's per-frame front
half), and a fired window runs only the window half of the head over its
32 buffered per-frame results: the per-window latency is one frame's
encode and the temporal head.  Float frames are then normalised frame by
frame (the [0, 255] heuristic of the window path is per window).

The model runs on ``device``: CUDA unless the caller passes the CPU;
asking for CUDA on a machine without a GPU raises.  Each fired window's
depth crosses to the host in ``transfer_dtype`` (JAX `eval/streaming.py:
85,124,126`), whatever the model's dtype.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from endodav_tpu_torch.eval.metrics import compute_scale_and_shift, interpolate_frames
from endodav_tpu_torch.eval.video_inference import (frame_scale, keep_aspect_size, torch_dtype,
                                                    upload_resized, window_chunk_forward)
from endodav_tpu_torch.models.endodav import INFER_LEN, INTERP_LEN, KEYFRAMES, OVERLAP
from endodav_tpu_torch.utils.precision import set_f32_policy

__all__ = ["DepthStreamer"]

_STEP = INFER_LEN - OVERLAP
_KF = np.asarray(KEYFRAMES, dtype=np.int64)


class DepthStreamer:
    """Incremental `infer_video_depth` over a live frame stream.

    forward_windows: the offline path's window forward,
      [1, INFER_LEN, th, tw, 3] -> [INFER_LEN, h', w', 1].
    image_shape: the model input target (keep-aspect lower bound, as the
      offline ``image_shape``).
    dedup: an optional `DedupWindowForward` of the same model.
    device: where the model runs ("cuda" by default).
    transfer_dtype: the numpy dtype of the window outputs' copy to the host.

    Output frames are stitched raw disparity [H, W] float32 at source
    resolution, the offline path's rows.
    """

    def __init__(self, forward_windows: Callable | None, image_shape=(224, 280), dedup=None,
                 device: torch.device | str = "cuda", transfer_dtype=np.float32):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DepthStreamer: no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        set_f32_policy()
        if forward_windows is None and dedup is None:
            raise ValueError("DepthStreamer needs forward_windows or dedup")
        self._fwd = forward_windows
        self._image_shape = tuple(image_shape)
        self._dedup = dedup
        self._transfer = torch_dtype(transfer_dtype)
        self._frames: dict[int, np.ndarray] = {}  # source index -> frame
        self._encoded: dict[int, tuple] = {}      # source index -> per-frame encode results
        self._n_pushed = 0
        self._win = 0                              # next window's ordinal
        self._prev_idx: np.ndarray | None = None   # the previous window's source indices
        self._tail: list[np.ndarray] = []          # provisional aligned frames
        self._src_hw: tuple[int, int] | None = None
        self._resized_hw: tuple[int, int] | None = None
        self._run = None                           # window path: one-window chunk forward
        self._head = None                          # dedup: the window half of the head
        self._flushed = False

    @property
    def frames_buffered(self) -> int:
        """Source frames (dedup: per-frame encode results) held now, fewer
        than 2*INFER_LEN."""
        return max(len(self._frames), len(self._encoded))

    def _bind_shapes(self, frame: np.ndarray):
        fh, fw = frame.shape[:2]
        self._src_hw = (fh, fw)
        self._resized_hw = keep_aspect_size(fh, fw, *self._image_shape)
        if self._dedup is not None:
            self._head = self._dedup.head_for(fh, fw, self._transfer)
        else:
            self._run = window_chunk_forward(self._fwd, fh, fw, self._transfer)

    def _window_idx(self, n_clamp: int) -> np.ndarray:
        """Source indices of window `self._win`, clamped to n_clamp - 1: the
        online form of `window_indices`."""
        s = _STEP * self._win
        idx = np.clip(np.arange(s, s + INFER_LEN), 0, n_clamp - 1)
        if self._win > 0:
            idx[:OVERLAP] = self._prev_idx[_KF]
        return idx

    def _fire_window(self, n_clamp: int) -> list[np.ndarray]:
        idx = self._window_idx(n_clamp)
        th, tw = self._resized_hw
        if self._dedup is not None:
            per_frame = [torch.cat(parts) for parts in zip(*(self._encoded[i] for i in idx))]
            slots = torch.arange(INFER_LEN, device=self.device)
            out = self._head(slots, *per_frame)
        else:
            stack = np.stack([self._frames[i] for i in idx], axis=0)
            if stack.dtype != np.uint8:  # the offline [0, 255] heuristic, on the window
                stack = stack.astype(np.float32)
            win = upload_resized(stack, frame_scale(stack), th, tw, self.device)
            out = self._run(win[None])
        out = out.cpu().float().numpy()  # [INFER_LEN, fh, fw]

        self._prev_idx = idx
        self._win += 1
        # later windows read only this window's keyframe slots (by source
        # index) and fresh frames from the next start on
        keep = {int(i) for i in idx[_KF]}
        nxt = _STEP * self._win
        self._frames = {i: f for i, f in self._frames.items() if i in keep or i >= nxt}
        self._encoded = {i: e for i, e in self._encoded.items() if i in keep or i >= nxt}

        # one window of `video_inference._stitch`
        if not self._tail:  # window 0
            aligned = list(out)
        else:
            pre = self._tail
            post = [out[i] for i in range(OVERLAP - INTERP_LEN, OVERLAP)]
            scale, shift = compute_scale_and_shift(np.concatenate(post), np.concatenate(pre))
            post = [np.maximum(f * scale + shift, 0.0) for f in post]
            aligned = interpolate_frames(pre, post)
            aligned.extend(np.maximum(out[i] * scale + shift, 0.0)
                           for i in range(OVERLAP, INFER_LEN))
        final, self._tail = aligned[:-INTERP_LEN], aligned[-INTERP_LEN:]
        return final

    def push(self, frame: np.ndarray) -> list[np.ndarray]:
        """Take one [H, W, 3] frame; return the depth frames now final."""
        if self._flushed:
            raise RuntimeError("DepthStreamer.push after flush")
        if self._src_hw is None:
            self._bind_shapes(frame)
        if tuple(frame.shape[:2]) != self._src_hw:
            raise ValueError(f"frame size {frame.shape[:2]} differs from the stream's "
                             f"{self._src_hw}")
        if self._dedup is not None:  # encode once, on arrival
            x = frame[None] if frame.dtype == np.uint8 else frame[None].astype(np.float32)
            batch = upload_resized(x, frame_scale(x), *self._resized_hw, self.device)
            self._encoded[self._n_pushed] = self._dedup.encode(batch)
        else:
            self._frames[self._n_pushed] = frame
        self._n_pushed += 1
        if self._n_pushed == _STEP * self._win + INFER_LEN:
            return self._fire_window(self._n_pushed)
        return []

    def flush(self) -> list[np.ndarray]:
        """End of stream: run the remaining windows with clamped padding and
        release every provisional frame, truncated to the frames pushed."""
        if self._flushed:
            raise RuntimeError("DepthStreamer.flush called twice")
        self._flushed = True
        n = self._n_pushed
        if n == 0:
            return []
        out: list[np.ndarray] = []
        num_windows = len(range(0, n, _STEP))  # the offline window count
        while self._win < num_windows:
            out.extend(self._fire_window(n))
        out.extend(self._tail)
        self._tail, self._frames, self._encoded = [], {}, {}
        emitted_before = (num_windows - 1) * _STEP + INFER_LEN - len(out)
        return out[: max(0, n - emitted_before)]
