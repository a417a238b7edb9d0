"""Camera constants of the SCARED pipeline (port of
`endodav_tpu/data/pipeline.py:NORMALIZED_K`)."""

from __future__ import annotations

import numpy as np

__all__ = ["NORMALIZED_K", "pixel_intrinsics"]

# fx=0.82W, fy=1.02H, c=0.5 (scared_video_dataset.py:193-196 of the reference)
NORMALIZED_K = np.array(
    [[0.82, 0, 0.5, 0], [0, 1.02, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32)


def pixel_intrinsics(n: int, h: int, w: int) -> np.ndarray:
    """[n, 4, 4] pixel intrinsics of n SCARED frames of size (h, w)."""
    K = NORMALIZED_K.copy()
    K[0, :] *= w
    K[1, :] *= h
    return np.repeat(K[None], n, axis=0)
