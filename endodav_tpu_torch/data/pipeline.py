"""Host-side preprocessing constants and helpers of the SCARED pipeline.

Numpy copies of `endodav_tpu/data/pipeline.py`: the normalized intrinsics
template and its per-scale scaling, the antialiased bilinear frame
resize and the ColorJitter parameter sampler (the jitter itself runs on
the card, `ops/jitter.py`).
"""

from __future__ import annotations

import numpy as np

from endodav_tpu_torch.ops.resize import interp_matrix

__all__ = ["NORMALIZED_K", "pixel_intrinsics", "scaled_intrinsics", "resize_frames",
           "sample_color_jitter"]

# fx=0.82W, fy=1.02H, c=0.5 (scared_video_dataset.py:193-196 of the reference)
NORMALIZED_K = np.array(
    [[0.82, 0, 0.5, 0], [0, 1.02, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32)


def pixel_intrinsics(n: int, h: int, w: int) -> np.ndarray:
    """[n, 4, 4] pixel intrinsics of n SCARED frames of size (h, w)."""
    K = NORMALIZED_K.copy()
    K[0, :] *= w
    K[1, :] *= h
    return np.repeat(K[None], n, axis=0)


def scaled_intrinsics(width: int, height: int, scale: int):
    """(K, inv_K) at pyramid level ``scale``."""
    K = NORMALIZED_K.copy()
    K[0, :] *= width // (2 ** scale)
    K[1, :] *= height // (2 ** scale)
    return K, np.linalg.pinv(K)


def resize_frames(frames: np.ndarray, out_hw: tuple[int, int], antialias: bool = True) -> np.ndarray:
    """Antialiased bilinear resize of [T, H, W, C] on the host."""
    _, h, w, _ = frames.shape
    oh, ow = out_hw
    mh = interp_matrix(h, oh, "bilinear", False, antialias=antialias)
    mw = interp_matrix(w, ow, "bilinear", False, antialias=antialias)
    out = np.einsum("ph,thwc->tpwc", mh, frames, optimize=True)
    out = np.einsum("qw,tpwc->tpqc", mw, out, optimize=True)
    return out.astype(frames.dtype)


def sample_color_jitter(rng: np.random.Generator):
    """torchvision ColorJitter((0.8,1.2),(0.8,1.2),(0.8,1.2),(-0.1,0.1))
    parameters: factors plus a random op order."""
    return {
        "order": rng.permutation(4),
        "brightness": rng.uniform(0.8, 1.2),
        "contrast": rng.uniform(0.8, 1.2),
        "saturation": rng.uniform(0.8, 1.2),
        "hue": rng.uniform(-0.1, 0.1),
    }
