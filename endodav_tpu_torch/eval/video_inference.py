"""Sliding-window full-video depth inference, on one device or over a
data mesh.

Port of `endodav_tpu/eval/video_inference.py:infer_video_depth`: the
window path, the dedup path (`DedupWindowForward`) and both stitches;
and of `infer_video_depth_single_frame`, the frame-independent inference
of a single-frame model (EndoDAC, AF-SfM).
Every window's 32 source-frame indices are known up front
(`window_indices` resolves the reference's keyframe-carry recurrence), so
windows batch `chunk_windows` at a time; only the scale/shift stitch runs
sequentially, on the host (``stitch="host"``) or as a few ops on the
device (``stitch="device"``, `_device_stitch`).

Frames upload once from pinned host memory as their own dtype (uint8
rides 4x smaller than f32), are scaled to [0, 1] and bicubic-resized to
the keep-aspect size on the device; the model's own bilinear
`preprocess` then takes them to ``image_shape``.  The two resizes stay
separate, as in the JAX package.

The serving options of the JAX function (`endodav_tpu/eval/
video_inference.py:511-671`): ``transfer_dtype`` is the dtype in which
the window outputs (host stitch) or the stitched video (device stitch)
cross to the host, ``np.float16`` in the TPU benchmark's headline; under
the device stitch the chunks stay f32 on the device.  ``sequential=True``
is the benchmark's baseline, the reference's loop: one window a chunk on
the window path, each window's output copied to the host before the next
is sent.  Whatever the model's dtype (``EndoDAV.dtype``), the result is
the disparity of the f32 path; a bf16 model's dedup results stay bf16.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from endodav_tpu_torch.eval.metrics import compute_scale_and_shift, interpolate_frames
from endodav_tpu_torch.models.endodav import (ENDODAV_CONFIGS, INFER_LEN, INTERP_LEN, KEYFRAMES,
                                              OVERLAP, prefix_map_shapes)
from endodav_tpu_torch.models.vit import VIT_CONFIGS
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.parallel import all_gather_rows, data_sharding
from endodav_tpu_torch.utils.envflags import env_auto, env_on

__all__ = ["keep_aspect_size", "window_indices", "stitch_plan", "infer_video_depth",
           "infer_video_depth_single_frame",
           "DedupWindowForward", "dedup_wins", "dedup_by_default", "frame_scale",
           "upload", "upload_resized", "window_chunk_forward", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (``np.float16`` -> ``torch.float16``)."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


class DedupWindowForward:
    """Unique-frame serving: encode each source frame once.

    Port of `endodav_tpu/eval/video_inference.py:45-216`.  The trunk is
    strictly per frame, so the OVERLAP keyframe-carried slots of each
    window need not be encoded again: `encode` runs the trunk (and, in
    prefix mode, the DPT head's per-frame front half) once per source
    frame; the head built by `head_for` gathers each window's slots from
    the per-frame results and runs the window half of the head.

    The boundary carries the four prefix maps when they are not
    materially bigger than the raw taps (vits), else the taps, and the
    head then runs the whole decode per window slot (vitl, whose maps are
    1.8x its taps); ``ENDODAV_DEDUP_PREFIX`` overrides.  Unlike the JAX
    package, which flattens the maps to 2D rows for the TPU's tiling, the
    port keeps them in their [frames, H, W, C] layout, in the model's
    dtype.
    """

    def __init__(self, model):
        self.model = model
        self.take = ENDODAV_CONFIGS[model.encoder]["intermediate"]
        self.map_shapes = prefix_map_shapes(model)
        ph, pw = model.patch_hw
        embed = VIT_CONFIGS[model.encoder]["embed_dim"]
        taps_elems = len(self.take) * (ph * pw + 1) * embed
        maps_elems = sum(int(np.prod(s)) for s in self.map_shapes)
        self.prefix_mode = env_auto("ENDODAV_DEDUP_PREFIX", maps_elems <= 1.25 * taps_elems)

    def encode(self, batch: torch.Tensor):
        """[fb, h, w, 3] frames in [0, 1] -> per-frame results: the four
        prefix maps, or the taps as (tokens [fb, k, N, C], cls [fb, k, C])."""
        with torch.inference_mode():
            taps = self.model.encode(batch[None])
            if self.prefix_mode:
                maps = self.model.decode_prefix(taps)
                assert tuple(tuple(m.shape[1:]) for m in maps) == self.map_shapes
                return tuple(maps)
            return (torch.stack([t for t, _ in taps], 1), torch.stack([c for _, c in taps], 1))

    def encode_batch_for(self, n_frames: int) -> int:
        """Encode batch size for an n-frame clip (the JAX package's rule:
        96 frames from 96 up, else INFER_LEN)."""
        return 96 if n_frames >= 96 else INFER_LEN

    def head_for(self, fh: int, fw: int, out_dtype: torch.dtype = torch.float32):
        """head(widx, *per_frame) -> [len(widx), fh, fw] disparity of the
        window slots ``widx`` (source-frame indices, windows of INFER_LEN),
        in ``out_dtype``."""
        model = self.model

        def head(widx: torch.Tensor, *per_frame):
            with torch.inference_mode():
                gathered = [p.index_select(0, widx) for p in per_frame]
                if self.prefix_mode:
                    out = model.decode_suffix(gathered, INFER_LEN)
                else:
                    tok, cls = gathered
                    taps = [(tok[:, i], cls[:, i]) for i in range(tok.shape[1])]
                    out = model.decode(taps, INFER_LEN)
                disp = resize2d(out[("disp", 0)], (fh, fw), "bilinear", align_corners=True)
                return disp[..., 0].to(out_dtype)

        return head


def dedup_wins(image_shape) -> bool:
    """The resolution gate of the dedup default: on iff the trunk input
    has at least 512 patch tokens (518x644 yes, 224x280 no)."""
    return (image_shape[0] // 14) * (image_shape[1] // 14) >= 512


def dedup_by_default(image_shape) -> bool:
    """The full default rule: ``ENDODAV_NO_DEDUP`` forces off,
    ``ENDODAV_DEDUP`` on, otherwise `dedup_wins`."""
    if env_on("ENDODAV_NO_DEDUP"):
        return False
    return env_on("ENDODAV_DEDUP") or dedup_wins(image_shape)


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


def _device_stitch(depth_chunks, num_windows: int, n: int, fh: int, fw: int,
                   out_dtype: torch.dtype = torch.float32,
                   device: torch.device | None = None) -> np.ndarray:
    """The stitch on ``device`` (default: the chunks'; `endodav_tpu/eval/
    video_inference.py:415-475`): per-boundary fit statistics, the
    absolute scale/shift of each window composed in order, then the gather
    and cross-fade blend in f32; only the stitched [n, fh, fw] video comes
    back to the host, in ``out_dtype``, returned as f32.  Unlike `_stitch`,
    the previous window's tail enters the fit unclamped, as in JAX."""
    win_a, slot_a, win_b, slot_b, wgt_b = stitch_plan(n, num_windows)
    align_len = OVERLAP - INTERP_LEN
    device = depth_chunks[0].device if device is None else device
    dw = torch.cat([c.to(device) for c in depth_chunks])[: num_windows * INFER_LEN].float()
    dw = dw.reshape(num_windows, INFER_LEN, fh, fw)
    sc = torch.ones(num_windows, device=device)
    sh = torch.zeros(num_windows, device=device)
    if num_windows > 1:
        post = dw[1:, align_len:OVERLAP].reshape(num_windows - 1, -1)
        pre = dw[:-1, INFER_LEN - INTERP_LEN:].reshape(num_windows - 1, -1)
        a00, a01 = (post * post).sum(1), post.sum(1)
        a11 = torch.full_like(a00, float(post.shape[1]))
        b0, b1 = (post * pre).sum(1), pre.sum(1)
        s_prev, t_prev = torch.ones((), device=device), torch.zeros((), device=device)
        for k in range(num_windows - 1):
            b0p = s_prev * b0[k] + t_prev * a01[k]
            b1p = s_prev * b1[k] + t_prev * a11[k]
            det = a00[k] * a11[k] - a01[k] * a01[k]
            ok = det != 0
            s_prev = torch.where(ok, (a11[k] * b0p - a01[k] * b1p) / det, 1.0)
            t_prev = torch.where(ok, (-a01[k] * b0p + a00[k] * b1p) / det, 0.0)
            sc[k + 1], sh[k + 1] = s_prev, t_prev
    flat = dw.reshape(num_windows * INFER_LEN, fh, fw)

    def fetch(win, slot):
        win = torch.from_numpy(win.astype(np.int64)).to(device)
        vals = flat.index_select(0, win * INFER_LEN + torch.from_numpy(slot.astype(np.int64))
                                 .to(device))
        return torch.clamp_min(vals * sc[win, None, None] + sh[win, None, None], 0.0)

    w = torch.from_numpy(wgt_b).to(device)[:, None, None]
    out = fetch(win_a, slot_a) * (1.0 - w) + fetch(win_b, slot_b) * w
    return out.to(out_dtype).cpu().float().numpy()


def frame_scale(frames: np.ndarray) -> float:
    """The divisor that brings frames to [0, 1]: 255 for uint8 and for
    float frames in [0, 255] (largest value above 1.5), else 1."""
    if frames.dtype == np.uint8:
        return 255.0
    return 255.0 if float(np.max(frames)) > 1.5 else 1.0


def upload(frames: np.ndarray, scale: float, device: torch.device) -> torch.Tensor:
    """Frames [n, H, W, 3] uploaded as their own dtype (pinned on CUDA) and
    divided by ``scale`` on the device, f32."""
    src = torch.from_numpy(np.ascontiguousarray(frames))
    if device.type == "cuda":
        src = src.pin_memory()
    slab = src.to(device, non_blocking=True).float()
    return slab / scale if scale != 1.0 else slab


def upload_resized(frames: np.ndarray, scale: float, th: int, tw: int,
                   device: torch.device) -> torch.Tensor:
    """`upload`, then a bicubic resize (align_corners=False) to (th, tw) on
    the device: the per-window preprocess of the JAX package
    (`eval/video_inference.py:_pre_fn`, `eval/streaming.py:108-126`)."""
    return resize2d(upload(frames, scale, device), (th, tw), "bicubic", align_corners=False)


def window_chunk_forward(forward_windows: Callable[[torch.Tensor], torch.Tensor], fh: int,
                         fw: int, out_dtype: torch.dtype = torch.float32
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[C, INFER_LEN, th, tw, 3] windows -> [C*INFER_LEN, fh, fw] disparity
    upsampled (bilinear, align_corners=True, in the model's dtype) to the
    source size and cast to ``out_dtype``: JAX's `_chunk_fn(forward_windows,
    C, ..., out_dtype)`; the streamer runs it with C=1."""

    def run(win: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            disp = forward_windows(win)
            disp = resize2d(disp, (fh, fw), "bilinear", align_corners=True)
            return disp[..., 0].to(out_dtype)

    return run


def infer_video_depth(
    forward_windows: Callable[[torch.Tensor], torch.Tensor],
    frames: np.ndarray,
    image_shape: tuple[int, int] = (224, 280),
    chunk_windows: int = 2,
    device: torch.device | str = "cuda",
    stitch: str = "host",
    dedup: DedupWindowForward | None = None,
    transfer_dtype=np.float32,
    sequential: bool = False,
    mesh=None,
) -> np.ndarray:
    """Full-video sigmoid-disparity inference.

    forward_windows: [C, INFER_LEN, h, w, 3] -> [C*INFER_LEN, h', w', 1]
      (the EndoDAV forward returning ("disp", 0)).
    frames: [N, H, W, 3] uint8, or float in [0, 255] or [0, 1].
    stitch: "host" (`_stitch`) or "device" (`_device_stitch`).
    dedup: a `DedupWindowForward`: each source frame is encoded once, in
      batches of `encode_batch_for(N)` frames (the last one padded with the
      last frame), and each chunk of windows (the last one trimmed, not
      padded) runs the head alone; ``ENDODAV_NO_DEDUP`` and ``sequential``
      turn it off.
    transfer_dtype: the numpy dtype in which depth crosses to the host: the
      window outputs under the host stitch, the stitched video under the
      device stitch (whose chunks stay f32).
    sequential: one window a chunk, on the window path, each synchronised
      by its copy to the host before the next runs (the baseline of the
      TPU benchmark, `bench.py:129-132`).
    mesh: a `parallel.Mesh` with a ``data`` axis of N ranks (JAX :582,
      :625-631): dedup is off, ``chunk_windows`` must be a multiple of N,
      each rank runs its N-th of every chunk's windows and every rank
      gathers the whole chunk's output before the stitch.
    Returns the stitched raw disparity [N, H, W] at source resolution, as
    JAX's: float64 from the host stitch, f32 from the device stitch.
    """
    if stitch not in ("host", "device"):
        raise ValueError(f"stitch must be 'host' or 'device', got {stitch!r}")
    data = 1 if mesh is None else mesh.axis_size("data")
    if mesh is not None:
        assert chunk_windows % data == 0, (
            "chunk_windows must be a multiple of the mesh 'data' axis")
    device = torch.device(device)
    n, fh, fw, _ = frames.shape
    th, tw = keep_aspect_size(fh, fw, *image_shape)
    if frames.dtype != np.uint8:
        frames = np.asarray(frames, np.float32)
    scale = frame_scale(frames)

    idx = window_indices(n)
    num_windows = idx.shape[0]
    if sequential:
        chunk_windows = 1
    transfer = torch_dtype(transfer_dtype)
    chunk_dtype = torch.float32 if stitch == "device" else transfer
    outs = []
    with torch.inference_mode():
        if (dedup is not None and not sequential and mesh is None
                and not env_on("ENDODAV_NO_DEDUP")):
            fb = dedup.encode_batch_for(n)
            pad_fidx = np.minimum(np.arange(-(-n // fb) * fb), n - 1)
            parts = [dedup.encode(upload_resized(frames[pad_fidx[b0:b0 + fb]], scale, th, tw,
                                                 device))
                     for b0 in range(0, len(pad_fidx), fb)]
            per_frame = [torch.cat(ps) if len(ps) > 1 else ps[0] for ps in zip(*parts)]
            del parts
            head = dedup.head_for(fh, fw, chunk_dtype)
            for c0 in range(0, num_windows, chunk_windows):
                w_idx = torch.from_numpy(idx[c0:c0 + chunk_windows].reshape(-1)).to(device)
                outs.append(head(w_idx, *per_frame))
        else:
            pad_to = math.ceil(num_windows / chunk_windows) * chunk_windows
            idx_padded = np.concatenate([idx, np.repeat(idx[-1:], pad_to - num_windows, axis=0)])
            resized = torch.empty((n, th, tw, 3), dtype=torch.float32, device=device)
            for s0 in range(0, n, INFER_LEN):
                resized[s0:s0 + INFER_LEN] = upload_resized(frames[s0:s0 + INFER_LEN], scale, th,
                                                            tw, device)
            run = window_chunk_forward(forward_windows, fh, fw, chunk_dtype)
            for c0 in range(0, pad_to, chunk_windows):
                w_idx = torch.from_numpy(idx_padded[c0:c0 + chunk_windows].reshape(-1)).to(device)
                win = resized.index_select(0, w_idx).reshape(chunk_windows, INFER_LEN, th, tw, 3)
                if data > 1:  # this rank's windows, then every rank's outputs
                    out = all_gather_rows(run(win[data_sharding(chunk_windows, mesh)]),
                                          mesh.group("data"))
                else:
                    out = run(win)
                outs.append(out.cpu() if sequential else out)
        if stitch == "device":
            return _device_stitch(outs, num_windows, n, fh, fw, transfer, device)
        outs = [o.cpu().float() for o in outs]
    depth_windows = torch.cat(outs).numpy()[: num_windows * INFER_LEN]
    return _stitch(depth_windows.reshape(num_windows, INFER_LEN, fh, fw), n)


def infer_video_depth_single_frame(
    forward_batch: Callable[[torch.Tensor], torch.Tensor],
    frames: np.ndarray,
    batch_size: int = 8,
    transfer_dtype=np.float32,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Frame-independent inference in batches of ``batch_size``
    (`endodav_tpu/eval/video_inference.py:673-737`).

    forward_batch: [B, H, W, 3] in [0, 1] -> [B, h', w', 1] disparity.
    frames: [N, H, W, 3] uint8, or float in [0, 255] or [0, 1]; each batch
      uploads as its own dtype and is scaled to [0, 1] on the device.
    Each batch's disparity is upsampled (bilinear, align_corners=True) to
    the source size and crosses to the host in ``transfer_dtype``.  The
    last batch runs at its own size: JAX pads it with copies of the last
    frame for XLA's static shapes, and frames are independent.  Returns
    [N, H, W] f32.
    """
    device = torch.device(device)
    n, fh, fw, _ = frames.shape
    if frames.dtype != np.uint8:
        frames = np.asarray(frames, np.float32)
    scale = frame_scale(frames)
    transfer = torch_dtype(transfer_dtype)
    outs = []
    with torch.inference_mode():
        for b0 in range(0, n, batch_size):
            batch = upload(frames[b0:b0 + batch_size], scale, device)
            disp = resize2d(forward_batch(batch), (fh, fw), "bilinear", align_corners=True)
            outs.append(disp[..., 0].to(transfer))
        return torch.cat(outs).cpu().float().numpy()
