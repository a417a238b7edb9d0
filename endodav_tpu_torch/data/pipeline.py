"""Host-side preprocessing constants and helpers of the SCARED pipeline.

Numpy copies of `endodav_tpu/data/pipeline.py`: the normalized intrinsics
template and its per-scale scaling, the antialiased bilinear frame
resize, the ColorJitter parameter sampler and its host-side application
(`apply_color_jitter`; the training step jitters on the card,
`ops/jitter.py`), and the cascaded pyramid of the frame datasets
(`build_pyramid`).
"""

from __future__ import annotations

import numpy as np

from endodav_tpu_torch.ops.resize import interp_matrix

__all__ = ["NORMALIZED_K", "pixel_intrinsics", "scaled_intrinsics", "resize_frames",
           "sample_color_jitter", "apply_color_jitter", "build_pyramid"]

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


def _grayscale(img):
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.max(img, axis=-1)
    minc = np.min(img, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q),
    ]
    r = np.choose(i, [c[0] for c in conds])
    g = np.choose(i, [c[1] for c in conds])
    b = np.choose(i, [c[2] for c in conds])
    return np.stack([r, g, b], axis=-1)


def apply_color_jitter(img: np.ndarray, params: dict) -> np.ndarray:
    """Apply sampled jitter to [..., H, W, 3] float images in [0, 1]."""
    out = img
    for op in params["order"]:
        if op == 0:
            out = np.clip(out * params["brightness"], 0.0, 1.0)
        elif op == 1:
            mean = _grayscale(out).mean()
            out = np.clip((out - mean) * params["contrast"] + mean, 0.0, 1.0)
        elif op == 2:
            gray = _grayscale(out)[..., None]
            out = np.clip((out - gray) * params["saturation"] + gray, 0.0, 1.0)
        else:
            hsv = _rgb_to_hsv(out)
            hsv[..., 0] = (hsv[..., 0] + params["hue"]) % 1.0
            out = _hsv_to_rgb(hsv)
    return out.astype(np.float32)


def build_pyramid(frames: np.ndarray, height: int, width: int, num_scales: int,
                  jitter_params: dict | None = None):
    """Cascaded pyramid (colors, colors_aug) per scale.

    frames: [T, H, W, 3] float32.  Returns two lists of [T, h_s, w_s, 3].
    """
    colors, colors_aug = [], []
    cur = frames
    for s in range(num_scales):
        cur = resize_frames(cur, (height // (2 ** s), width // (2 ** s)))
        colors.append(cur)
        colors_aug.append(apply_color_jitter(cur, jitter_params) if jitter_params else cur)
    return colors, colors_aug
