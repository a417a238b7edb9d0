"""Colour jitter and the training pyramid, on the card.

Port of `endodav_tpu/ops/jitter.py:22-123`: the torchvision ColorJitter
ops (brightness, contrast, saturation, hue through HSV) applied in a
per-item order, and the cascaded antialiased bilinear pyramid built from
the scale-0 frames the loader ships.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["device_color_jitter", "device_pyramid"]


def _grayscale(img):
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(-1)
    minc = img.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sel = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = []
    for ch in range(3):
        val = sel[5][ch]
        for k in range(4, -1, -1):
            val = torch.where(i == k, sel[k][ch], val)
        out.append(val)
    return torch.stack(out, dim=-1)


def _apply(op: int, img, factors):
    f = factors[op]
    if op == 0:
        return (img * f).clamp(0.0, 1.0)
    if op == 1:
        mean = _grayscale(img).mean()
        return ((img - mean) * f + mean).clamp(0.0, 1.0)
    if op == 2:
        gray = _grayscale(img)[..., None]
        return ((img - gray) * f + gray).clamp(0.0, 1.0)
    if float(f) == 0.0:  # identity hue: the HSV round trip is not bit-exact
        return img
    hsv = _rgb_to_hsv(img)
    hue = torch.remainder(hsv[..., 0] + f, 1.0)
    return _hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1))


def device_color_jitter(img: torch.Tensor, order, factors: torch.Tensor) -> torch.Tensor:
    """One item's jitter on [..., H, W, 3] float images in [0, 1]; order is
    a permutation of {0: brightness, 1: contrast, 2: saturation, 3: hue}
    and factors [4] is indexed by op (`data/pipeline.sample_color_jitter`)."""
    for op in [int(o) for o in order]:
        img = _apply(op, img, factors)
    return img


def device_pyramid(scale0: torch.Tensor, num_scales: int, order=None, factors=None):
    """Cascaded antialiased pyramid (+ optional jitter per scale) from
    scale0 [N, H, W, 3]; returns (colors per scale, jittered colors)."""
    colors, colors_aug = [], []
    cur = scale0
    h, w = scale0.shape[1:3]
    for s in range(num_scales):
        if s > 0:
            cur = resize2d(cur, (h // 2 ** s, w // 2 ** s), "bilinear", align_corners=False,
                           antialias=True)
        colors.append(cur)
        colors_aug.append(cur if order is None else device_color_jitter(cur, order, factors))
    return tuple(colors), tuple(colors_aug)
