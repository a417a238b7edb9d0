"""Port parity of the warp path on the CPU: `ops/sampling.py` and the plain
versions of the warp kernels against the JAX package.

The JAX side runs its XLA gather/scatter (`ops/sampling.py` off the TPU)
and its Pallas kernels `grid_sample_mm` / `splat_mm` in interpret mode,
as `tests/test_warp_matmul.py` does.  Inputs come from numpy seeds.
Tolerances: 1e-5 against the XLA formulation (the same f32 arithmetic);
against the Pallas kernels 1e-5 on outputs and 2e-4 on gradients, the
bound `tests/test_warp_matmul.py` holds the kernels' compensated bf16
matmuls to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu.ops import sampling as jsampling
from endodav_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)

TOL, KERNEL_GRAD_TOL = 1e-5, 2e-4


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_()


def _frac(grid, h, w, align_corners):
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)
    return ((gx + 1.0) * w - 1.0) * 0.5, ((gy + 1.0) * h - 1.0) * 0.5


def _case(c, tile, seed, b=2, h=24, w=40, ho=16, wo=33):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (b * tile, ho, wo, 2)).astype(np.float32)  # out of range too
    wgt = rng.standard_normal((b * tile, ho, wo, c)).astype(np.float32)
    return img, grid, wgt


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", [1, 4])
def test_grid_sample_matches_jax(c, mode, ac, tile):
    """Forward and gradients (image and grid) against the JAX XLA path."""
    img, grid, wgt = _case(c, tile, seed=c * 100 + tile)
    img_grad = tile == 1

    def jloss(i, g):
        return (jsampling.grid_sample(i, g, mode, ac, img_grad, tile) * wgt).sum()

    want = jsampling.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode, ac, img_grad, tile)
    jgi, jgg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti, tg = _t(img), _t(grid)
    got = tsampling.grid_sample(ti, tg, mode, ac, img_grad, tile)
    (got * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), atol=TOL, rtol=TOL)
    if img_grad:
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=TOL, rtol=TOL)
    else:  # declared gradient-free
        assert ti.grad is None


@pytest.mark.parametrize("c,zeros,ac,tile", [(3, False, True, 4), (1, True, True, 1),
                                             (2, False, False, 1)])
def test_grid_sample_matches_pallas_interpret(c, zeros, ac, tile):
    """Against `grid_sample_mm` run in interpret mode, at the three warp
    kinds of the training step (colour synthesis, depth, consistency)."""
    from endodav_tpu.kernels.warp_matmul import grid_sample_mm
    from endodav_tpu_torch.kernels.warp_matmul import grid_sample_mm as tgrid_sample_mm

    img, grid, wgt = _case(c, tile, seed=7 + c, b=1, h=16, w=24, ho=9, wo=13)
    img_grad = tile == 1
    h, w = img.shape[1:3]

    def jloss(i, g):
        fx, fy = _frac(g, h, w, ac)
        return (grid_sample_mm(i, fx, fy, zeros, ac, img_grad, tile) * wgt).sum()

    with pltpu.force_tpu_interpret_mode():
        fx, fy = _frac(jnp.asarray(grid), h, w, ac)
        want = grid_sample_mm(jnp.asarray(img), fx, fy, zeros, ac, img_grad, tile)
        jgi, jgg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti, tg = _t(img), _t(grid)
    tfx, tfy = _frac(tg, h, w, ac)
    got = tgrid_sample_mm(ti, tfx, tfy, zeros, img_grad, tile)
    (got * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), atol=KERNEL_GRAD_TOL,
                               rtol=KERNEL_GRAD_TOL)
    if img_grad:
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=KERNEL_GRAD_TOL,
                                   rtol=KERNEL_GRAD_TOL)


def _splat_coords(seed, b=2, h=20, w=28):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flow = rng.normal(0, 2.0, (b, h, w, 2))
    return np.stack([xx + flow[..., 1], yy + flow[..., 0]], -1).astype(np.float32), h, w


def test_splat_matches_jax_and_pallas_interpret():
    from endodav_tpu.kernels.warp_matmul import splat_mm

    coords, h, w = _splat_coords(3)
    want = np.asarray(jsampling._splat_xla(jnp.asarray(coords), h, w))
    with pltpu.force_tpu_interpret_mode():
        b = coords.shape[0]
        kern = np.asarray(splat_mm(jnp.asarray(coords[..., 0].reshape(b, -1)),
                                   jnp.asarray(coords[..., 1].reshape(b, -1)), h, w))
    got = tsampling.forward_splat_occupancy(torch.from_numpy(coords), h, w).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[..., 0], kern, atol=TOL, rtol=TOL)
    assert int(((got > 0.95) != (want > 0.95)).sum()) == 0


def test_splat_gradient_matches_jax_custom_vjp():
    """The splat's gradient equals `_splat_fast_bwd` (the XLA recompute)."""
    coords, h, w = _splat_coords(4)
    g = np.random.default_rng(5).standard_normal((coords.shape[0], h, w, 1)).astype(np.float32)
    (want,) = jsampling._splat_fast_bwd(h, w, jnp.asarray(coords), jnp.asarray(g))
    tc = _t(coords)
    (tsampling.forward_splat_occupancy(tc, h, w) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_occlusion_mask_and_flow_consistency_match_jax():
    rng = np.random.default_rng(6)
    f12 = rng.normal(0, 1.5, (2, 20, 28, 2)).astype(np.float32)
    f21 = rng.normal(0, 1.5, (2, 20, 28, 2)).astype(np.float32)
    jmask, jmap = jsampling.occlusion_mask_backward(jnp.asarray(f21))
    tmask, tmap = tsampling.occlusion_mask_backward(torch.from_numpy(f21))
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = jsampling.flow_consistency(jnp.asarray(f12), jnp.asarray(f21))
    got = tsampling.flow_consistency(torch.from_numpy(f12), torch.from_numpy(f21))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_flow_warp_and_flow_to_grid_match_jax():
    rng = np.random.default_rng(8)
    src = rng.uniform(0, 1, (2, 20, 28, 3)).astype(np.float32)
    flow = rng.normal(0, 2.0, (8, 20, 28, 2)).astype(np.float32)
    np.testing.assert_allclose(tsampling.flow_to_grid(torch.from_numpy(flow)).numpy(),
                               np.asarray(jsampling.flow_to_grid(jnp.asarray(flow))), atol=TOL)
    want = jsampling.flow_warp(jnp.asarray(src), jnp.asarray(flow), img_grad=False, img_tile=4)
    got = tsampling.flow_warp(torch.from_numpy(src), torch.from_numpy(flow), img_grad=False,
                              img_tile=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("in_size,out_size", [(256, 128), (128, 64), (1024, 256), (320, 160),
                                              (7, 7)])
def test_antialiased_resize_matches_jax(in_size, out_size):
    from endodav_tpu.ops import resize as jresize
    from endodav_tpu_torch.ops import resize as tresize

    want = jresize.interp_matrix(in_size, out_size, "bilinear", False, True)
    got = tresize.interp_matrix(in_size, out_size, "bilinear", False, antialias=True)
    np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(in_size).uniform(0, 1, (2, in_size, in_size // 2 + 3, 3))
    x = x.astype(np.float32)
    size = (out_size, max(1, (in_size // 2 + 3) * out_size // in_size))
    np.testing.assert_allclose(
        tresize.resize2d(torch.from_numpy(x), size, "bilinear", antialias=True).numpy(),
        np.asarray(jresize.resize2d(jnp.asarray(x), size, "bilinear", antialias=True)),
        atol=1e-5, rtol=1e-5)
