"""The forward splat on the CPU, on the kinds of coordinates its callers and
its tiles of source pixels meet.

On a CPU tensor `kernels/warp_matmul.py:splat_mm` is the plain version
(`splat_reference`: four `index_add` scatters of f32 masses).  Here it is
held against the JAX package's `ops/sampling._splat_xla` (its XLA scatter)
and its Pallas `splat_mm` in interpret mode at 1e-5 (f32 sums of at most
four masses of at most 1 a map pixel, in other orders), and against itself
in float64 at 1e-6, on raster coordinates moved by a small flow, on a
displaced column of 32 source pixels, on P != H * W, on grids that 32 x 32
tiles do not divide, and on corners clipped at all four borders; and on
hand-made NaN, infinite and out-of-map coordinates, whose masses are worked
out by hand.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu.ops import sampling as jsampling
from endodav_tpu_torch.kernels import warp_matmul as W

torch.set_num_threads(1)

TOL, F64_TOL = 1e-5, 1e-6


def _raster(rng, b, h, w, noise=1.5, scale=1.0, shift=(0.0, 0.0)):
    """Coordinates [b, h * w] of a raster source grid on an h x w map: the
    pixel grid scaled about the origin, shifted, plus Gaussian noise."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = xx * scale + shift[0] + rng.normal(0, noise, (b, h, w))
    y = yy * scale + shift[1] + rng.normal(0, noise, (b, h, w))
    return x.reshape(b, -1), y.reshape(b, -1), h, w


def _case(name):
    """(x, y [B, P] f32, map h, w)."""
    rng = np.random.default_rng(CASES.index(name) + 11)
    if name == "fit":  # raster, small flow: neighbours stay neighbours
        x, y, h, w = _raster(rng, 2, 64, 96)
    elif name == "wild":  # the first 32 columns displaced by up to +-60 px
        x, y, h, w = _raster(rng, 2, 96, 128)
        far = np.tile(np.arange(w) < 32, h) * 60.0
        x = x + far * rng.uniform(-1, 1, x.shape)
        y = y + far * rng.uniform(-1, 1, y.shape)
    elif name == "nonraster":  # P != H * W
        h, w = 40, 50
        x = rng.uniform(-2, w + 1, (2, 3000))
        y = rng.uniform(-2, h + 1, (2, 3000))
    elif name == "ragged":  # 70 x 75: 32 x 32 tiles leave a partial row and column
        x, y, h, w = _raster(rng, 2, 70, 75)
    else:  # "clipped": spread past all four borders, corners clipped on every side
        x, y, h, w = _raster(rng, 2, 40, 56, noise=0.7, scale=1.25, shift=(-6.0, -5.0))
    return x.astype(np.float32), y.astype(np.float32), h, w


CASES = ["fit", "wild", "nonraster", "ragged", "clipped"]


@pytest.mark.parametrize("name", CASES)
def test_splat_matches_jax_and_pallas(name):
    x, y, h, w = _case(name)
    b, p = x.shape
    got = W.splat_mm(torch.from_numpy(x), torch.from_numpy(y), h, w)
    assert got.dtype == torch.float32 and got.shape == (b, h, w)

    # JAX's XLA scatter takes coordinates [B, H', W', 2]; any grid of P works
    coords = np.stack([x, y], -1).reshape(b, 1, p, 2)
    want = np.asarray(jsampling._splat_xla(jnp.asarray(coords), h, w))[..., 0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    with pltpu.force_tpu_interpret_mode():
        from endodav_tpu.kernels.warp_matmul import splat_mm

        kern = np.asarray(splat_mm(jnp.asarray(x), jnp.asarray(y), h, w))
    np.testing.assert_allclose(got.numpy(), kern, atol=TOL, rtol=TOL)
    assert int(((got.numpy() > 0.95) != (want > 0.95)).sum()) == 0


@pytest.mark.parametrize("name", CASES)
def test_splat_matches_float64(name):
    """The f32 splat, which rounds after each of its four scatters, stays
    within 1e-6 of the same scatters in float64."""
    x, y, h, w = _case(name)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = W.splat_reference(tx.double(), ty.double(), h, w)
    np.testing.assert_allclose(W.splat_mm(tx, ty, h, w).double().numpy(), want.numpy(),
                               atol=F64_TOL, rtol=F64_TOL)


# (x, y) on a 32 x 64 map -> {(row, column): mass}; a corner outside the
# map takes nothing, NaN and infinite coordinates reach no map pixel
HAND_MADE = [((5.5, 7.25), {(7, 5): 0.375, (7, 6): 0.375, (8, 5): 0.125, (8, 6): 0.125}),
             ((-0.5, 3.0), {(3, 0): 0.5}),  # floor column -1 is out, row 4 has factor 0
             ((-1.0, 5.0), {}),  # the one corner inside (column 0) has factor 0
             ((62.75, 31.5), {(31, 62): 0.125, (31, 63): 0.375}),  # row 32 is out
             ((63.0, 31.0), {(31, 63): 1.0}),
             ((float("nan"), 3.0), {}),
             ((2.0, float("inf")), {}),
             ((1e6, 4.0), {})]


@pytest.mark.parametrize("point,cells", HAND_MADE)
def test_splat_on_hand_made_coordinates(point, cells):
    """One source pixel's masses, beside a pixel at (10.5, 20.5) that puts
    a quarter on each of its four corners, in one map."""
    x = torch.tensor([[point[0], 10.5]], dtype=torch.float32)
    y = torch.tensor([[point[1], 20.5]], dtype=torch.float32)
    want = np.zeros((1, 32, 64), np.float32)
    for r, c in ((20, 10), (20, 11), (21, 10), (21, 11)):
        want[0, r, c] = 0.25
    for (r, c), m in cells.items():
        want[0, r, c] += m
    got = W.splat_mm(x, y, 32, 64).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
