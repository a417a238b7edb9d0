"""Port parity of the channel-plane warp route (``ENDODAV_WARP_CP=1``) on the
CPU against the JAX package: the port's `grid_sample_mm` (its plane
layout's plain version, `grid_sample_planes_reference`, for CPU tensors)
against JAX's plane-layout Pallas kernels in interpret mode (Pallas's
generic interpreter), forward and
both gradients, at `tests/test_warp_matmul.py`'s shapes and tolerances
(outputs 1e-5; gradients 2e-4 absolute and 1e-4 relative, the bound of
the kernels' compensated bf16 matmuls), plus the colour-synthesis call
(C=3, img_tile 4, coordinate-only backward) and the flow-consistency call
(C=2, fused backward); and `use_cp` against JAX's `_use_cp`.  Inputs come
from numpy seeds."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.kernels import warp_matmul as W

torch.set_num_threads(1)


@contextlib.contextmanager
def pallas_interpret():
    """Every `pl.pallas_call` of the JAX kernels on Pallas's generic
    interpreter (`interpret=True`: the kernel body as plain JAX ops).  The
    TPU interpret mode (`pltpu.force_tpu_interpret_mode`) runs jnp inside
    `io_callback`s, which can deadlock against eager dispatch on this CPU."""
    real = pl.pallas_call
    pl.pallas_call = lambda *a, **k: real(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        pl.pallas_call = real


TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4, 1e-4


@pytest.fixture
def cp_on(monkeypatch):
    monkeypatch.setenv("ENDODAV_WARP_CP", "1")


@pytest.mark.parametrize("c,b,h,w,zeros,tile", [
    (3, 2, 32, 40, True, 1),    # tests/test_warp_matmul.py's channel-plane case
    (3, 2, 24, 40, False, 4),   # colour synthesis: img_tile, coordinate-only backward
    (2, 3, 16, 24, False, 1),   # flow consistency: C=2, fused backward
])
def test_channel_plane_route_matches_jax(cp_on, c, b, h, w, zeros, tile):
    from endodav_tpu.kernels import warp_matmul as jwm

    rng = np.random.default_rng(11 + c + tile)
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    fx = rng.uniform(-2, w + 1, (b * tile, h, w)).astype(np.float32)
    fy = rng.uniform(-2, h + 1, (b * tile, h, w)).astype(np.float32)
    img_grad = tile == 1

    def jloss(im, x, y):
        return (jwm.grid_sample_mm(im, x, y, zeros, True, img_grad, tile) ** 2).sum()

    assert jwm._use_cp(c)
    with pallas_interpret():
        want = jwm.grid_sample_mm(*map(jnp.asarray, (img, fx, fy)), zeros, True, img_grad, tile)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (img, fx, fy)))
    ti, tx, ty = (torch.from_numpy(a).requires_grad_() for a in (img, fx, fy))
    got = W.grid_sample_mm(ti, tx, ty, zeros, img_grad, tile)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    pairs = [(tx.grad, jgrads[1]), (ty.grad, jgrads[2])]
    if img_grad:
        pairs.append((ti.grad, jgrads[0]))
    else:
        assert ti.grad is None  # declared gradient-free
    for a, j in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_plane_plain_version_equals_the_interleaved_one():
    """The two plain versions compute one function: the planes are only a
    layout (also with img_tile and outside coordinates in zeros mode)."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.standard_normal((2, 7, 9, 4)).astype(np.float32))
    fx = torch.from_numpy(rng.uniform(-3, 11, (6, 5, 4)).astype(np.float32))
    fy = torch.from_numpy(rng.uniform(-3, 9, (6, 5, 4)).astype(np.float32))
    for zeros in (False, True):
        want = W.grid_sample_reference(img, fx, fy, zeros, 3)
        got = W.grid_sample_planes_reference(W.to_planes(img), fx, fy, zeros, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("flag", [None, "1", "0", "true", "off"])
def test_use_cp_selects_as_jax(monkeypatch, flag):
    from endodav_tpu.kernels import warp_matmul as jwm

    if flag is None:
        monkeypatch.delenv("ENDODAV_WARP_CP", raising=False)
    else:
        monkeypatch.setenv("ENDODAV_WARP_CP", flag)
    for c in (1, 2, 3, 4):
        assert W.use_cp(c) == jwm._use_cp(c)
    assert not W.use_cp(1)  # a single channel never takes planes
