"""Camera geometry needed by the serving path (port of
`endodav_tpu/geometry/transforms.py:disp_to_depth`)."""

from __future__ import annotations

__all__ = ["disp_to_depth"]


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth) in [min_depth, max_depth].
    Works on numpy arrays and torch tensors alike."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp
