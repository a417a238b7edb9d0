"""The fused warp backward's tile decomposition on the CPU.

`csrc/warp.cu`'s fused backward sums each tile's d_img contributions in
shared memory over the bounding box of the tile's clipped corners when the
box fits its budget, and adds the other tiles' per pixel into d_img.
`kernels/warp_matmul.py:bwd_tiled_reference` is that partition in plain
PyTorch and `tile_fit_share` its box rule.  Here the decomposition is held
against float64 and against the JAX package's gradients of
`ops/sampling.grid_sample` (its XLA gather on the CPU), at 1e-5, for C = 1
to 4, both padding modes, both image layouts, an output grid whose pixel
count is not a multiple of 4, and coordinates whose every box fits as well
as displacements that send some tiles to the per-pixel branch.  Inputs
come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu.ops import sampling as jsampling
from endodav_tpu_torch.kernels import warp_matmul as W

torch.set_num_threads(1)

TOL = 1e-5
H, W_, OUT = 96, 128, (70, 75)  # image; output grid of 5250 pixels, 3 x 3 tiles


def _case(c, zeros, wild, seed):
    """f32 img [2, H, W, C], normalised grid [2, *OUT, 2], cotangent; the
    grid follows the output pixels (1.5 px noise), and with ``wild`` its
    first tile column is displaced by up to +-60 px."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (2, H, W_, c)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(OUT[0]), np.arange(OUT[1]), indexing="ij")
    fx = xx + 10 + rng.normal(0, 1.5, (2, *OUT))
    fy = yy + 10 + rng.normal(0, 1.5, (2, *OUT))
    if wild:
        far = 60 * (xx < W.BWD_TILE[1])
        fx = fx + far * rng.uniform(-1, 1, (2, *OUT))
        fy = fy + far * rng.uniform(-1, 1, (2, *OUT))
    # align_corners=True: the grid whose pixel coordinates are fx, fy
    grid = np.stack([fx / (W_ - 1) * 2 - 1, fy / (H - 1) * 2 - 1], -1).astype(np.float32)
    cot = rng.standard_normal((2, *OUT, c)).astype(np.float32)
    return img, grid, cot


def _frac(grid):
    """Pixel coordinates from the grid in f32, as `ops/sampling.grid_sample` forms them."""
    gx, gy = grid[..., 0], grid[..., 1]
    return (gx + 1.0) * 0.5 * (W_ - 1), (gy + 1.0) * 0.5 * (H - 1)


@pytest.mark.parametrize("wild", [False, True], ids=["fit", "wild"])
@pytest.mark.parametrize("planes", [False, True], ids=["interleaved", "planes"])
@pytest.mark.parametrize("zeros", [True, False], ids=["zeros", "border"])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_tiled_backward_matches_float64_and_jax(c, zeros, planes, wild):
    img, grid, cot = _case(c, zeros, wild, seed=10 * c + 2 * zeros + wild)
    fx, fy = (torch.from_numpy(f) for f in _frac(grid))
    share = W.tile_fit_share(fx, fy, H, W_, c)
    if wild:  # both branches: the wild column's boxes overflow, the others fit
        assert 0 < share < 1
    else:
        assert share == 1
    ti, tg = torch.from_numpy(img), torch.from_numpy(cot)
    src = W.to_planes(ti) if planes else ti
    dimg, dfx, dfy, got_share = W.bwd_tiled_reference(src, fx, fy, tg, zeros, planes)
    assert got_share == share
    if planes:
        dimg = dimg.permute(0, 2, 3, 1)

    # float64: autograd of the plain gather on the same f32 inputs
    i, x, y = (t.double().requires_grad_() for t in (ti, fx, fy))
    want = torch.autograd.grad(W.grid_sample_reference(i, x, y, zeros), (i, x, y), tg.double())
    for a, b in zip((dimg, dfx, dfy), want):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), atol=TOL, rtol=TOL)

    # JAX: the gradient of ops/sampling.grid_sample, whose d_grid is
    # d_f * (size - 1) / 2: compared in pixel units, d_f
    mode = "zeros" if zeros else "border"

    def loss(im, gr):
        return (jsampling.grid_sample(im, gr, mode, True) * cot).sum()

    jdimg, jdgrid = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_allclose(dimg.numpy(), np.asarray(jdimg), atol=TOL, rtol=TOL)
    for got, jd, size in ((dfx, jdgrid[..., 0], W_), (dfy, jdgrid[..., 1], H)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jd) / ((size - 1) * 0.5), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("budget,share", [(200, 1.0), (199, 0.5), (28, 0.5), (27, 0.0)])
def test_tile_fit_share_on_hand_made_coordinates(budget, share):
    """Two tiles of one 32 x 64 grid on a 40 x 50 image, C = 2.  Both sample
    at (5.5, 7.25), corners x 5-6 and y 7-8.  In the left tile one x is NaN,
    whose corners clip to 0: a box of x 0-6, y 7-8, 14 pixels, 28 floats.
    The right tile reaches x = -3 and 1e6, clipped to 0 and 49: a box of
    50 x 2 pixels, 200 floats."""
    fx = torch.full((1, 32, 64), 5.5)
    fy = torch.full((1, 32, 64), 7.25)
    fx[0, 3, 4] = float("nan")
    fx[0, 0, 40], fx[0, 9, 63] = -3.0, 1e6
    assert W.tile_fit_share(fx, fy, 40, 50, 2, budget=budget) == share


def test_tile_fit_share_clips_out_of_image_and_infinite_coordinates():
    """Coordinates far outside the image or infinite clip to its border
    rows and columns, so a tile's box never leaves the image: one tile
    reaching both corners of a 30 x 30 image boxes all 900 pixels."""
    fx = torch.full((2, 32, 32), 3.5)
    fy = torch.full((2, 32, 32), 3.5)
    fx[1, 0, 0], fy[1, 0, 0] = float("-inf"), -7.0
    fx[1, 5, 5], fy[1, 5, 5] = float("inf"), 1e9
    assert W.tile_fit_share(fx, fy, 30, 30, 1, budget=900) == 1.0
    assert W.tile_fit_share(fx, fy, 30, 30, 1, budget=899) == 0.5
    assert W.tile_fit_share(fx, fy, 30, 30, 1, budget=4) == 0.5  # the first tile: 2 x 2
