"""Port parity of the fused ResidualConvUnit on the CPU against the JAX
package: `kernels/fused_rcu.py` (the plain version, which the wrapper
runs for CPU tensors) against JAX's Pallas kernel in interpret mode at
the geometries of `tests/test_fused_rcu.py` (1e-5, the bound that file
holds the kernel to), its gradient, the `ResidualConvUnit` and the vits
DPT head with ``ENDODAV_FUSED_RCU=1`` against JAX's fused route, and the
route itself.  Inputs and weights come from numpy seeds; the head's
weights are carried across with `from_jax_params`."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.kernels import fused_rcu as fr
from endodav_tpu_torch.models import dpt as tdpt
from endodav_tpu_torch.utils.convert import from_jax_params

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


TOL = 1e-5


def _params(c, seed):
    rng = np.random.default_rng(seed)
    w1, w2 = ((rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.standard_normal(c) * 0.1).astype(np.float32) for _ in range(2))
    return w1, b1, w2, b2


def _convs(w1, b1, w2, b2):
    """Two nn.Conv2d holding the JAX HWIO weights in the torch layout."""
    c = w1.shape[-1]
    convs = []
    for w, b in ((w1, b1), (w2, b2)):
        conv = torch.nn.Conv2d(c, c, 3, padding=1)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(np.transpose(w, (3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(b))
        convs.append(conv)
    return convs


@pytest.mark.parametrize("b,h,w,c,bh", [
    (2, 16, 24, 64, 8),    # even bands
    (1, 10, 24, 64, 8),    # H not a band multiple
    (1, 6, 16, 64, 8),     # a frame smaller than one band (and one CUDA tile)
    (2, 9, 8, 128, 4),     # odd H, the C=128 upper bound
])
def test_fused_rcu_matches_jax_kernel(b, h, w, c, bh):
    from endodav_tpu.kernels.fused_rcu import fused_rcu as jfused_rcu

    x = np.random.default_rng(b * h * w).standard_normal((b, h, w, c)).astype(np.float32)
    params = _params(c, seed=h)
    want = np.asarray(jfused_rcu(jnp.asarray(x), *map(jnp.asarray, params), bh, True))
    conv1, conv2 = _convs(*params)
    with torch.no_grad():
        got = fr.fused_rcu(torch.from_numpy(x), conv1, conv2).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fused_rcu_gradient_matches_jax(monkeypatch):
    """The autograd.Function's plain-recompute backward (the card's route,
    with the launch replaced by the plain version so it runs here) against
    JAX's custom_vjp, for x and all four parameters."""
    from endodav_tpu.kernels.fused_rcu import fused_rcu as jfused_rcu

    x = np.random.default_rng(3).standard_normal((1, 8, 16, 64)).astype(np.float32)
    params = _params(64, seed=4)

    def jloss(*a):
        return (jfused_rcu(*a, 8, True) ** 2).mean()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *map(jnp.asarray, params))
    monkeypatch.setattr(fr, "_launch", fr.rcu_reference)
    conv1, conv2 = _convs(*params)
    xt = torch.from_numpy(x).requires_grad_()
    args = (xt, conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    out = fr._FusedRCU.apply(*args)
    assert out.grad_fn is not None
    (out ** 2).mean().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), atol=1e-6, rtol=1e-5)
    for t, j, bias in ((conv1.weight, want[1], False), (conv1.bias, want[2], True),
                       (conv2.weight, want[3], False), (conv2.bias, want[4], True)):
        j = np.asarray(j) if bias else np.transpose(np.asarray(j), (3, 2, 0, 1))
        np.testing.assert_allclose(t.grad.numpy(), j, atol=1e-6, rtol=1e-5)


def test_kernel_taps_layout():
    """kernel_taps puts the torch weight's tap (ky, kx) for input ci and
    output co at [3*ky + kx, co, ci]: K-major taps, the tensor-core
    kernel's B operand (tap 3*ky + kx as the TPU kernel's [9C, C] panels),
    zero past C when padded to the kernel's width."""
    w = torch.arange(4 * 4 * 9, dtype=torch.float32).reshape(4, 4, 3, 3)
    taps = fr.kernel_taps(w, torch.bfloat16)
    assert taps.shape == (9, 4, 4) and taps.dtype == torch.bfloat16 and taps.is_contiguous()
    for ky, kx, ci, co in ((0, 0, 0, 0), (2, 1, 3, 0), (1, 2, 0, 3)):
        assert taps[3 * ky + kx, co, ci] == w[co, ci, ky, kx].to(torch.bfloat16)
    padded = fr.kernel_taps(w, torch.float32, 16)
    assert padded.shape == (9, 16, 16) and torch.equal(padded[:, :4, :4], taps.float())
    assert padded[:, 4:].abs().sum() == 0 and padded[:, :, 4:].abs().sum() == 0


class _TpuBackendJax:
    """`jax` as JAX's dpt.py sees it on a TPU: `default_backend()` says
    "tpu", everything else is jax itself."""

    def __getattr__(self, name):
        return (lambda: "tpu") if name == "default_backend" else getattr(jax, name)


@pytest.fixture
def jax_fused_rcu_route(monkeypatch):
    """JAX's serving route on this CPU: dpt.py told it runs on a TPU, so
    its RCUs take the Pallas kernel, and the motion modules on their fused
    block, both run by the tests in `pallas_interpret`; ENDODAV_FUSED_RCU
    on for both packages."""
    from endodav_tpu.models import dpt as jdpt
    from endodav_tpu.models import motion as jmotion

    monkeypatch.setattr(jdpt, "jax", _TpuBackendJax())
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    monkeypatch.setenv("ENDODAV_FUSED_RCU", "1")


def test_residual_conv_unit_matches_jax(jax_fused_rcu_route):
    from endodav_tpu.models.dpt import ResidualConvUnit as JRCU

    x = np.random.default_rng(5).standard_normal((2, 12, 20, 64)).astype(np.float32)
    jm = JRCU(64)
    params = _params(64, seed=6)
    p = {"conv1": {"kernel": params[0], "bias": params[1]},
         "conv2": {"kernel": params[2], "bias": params[3]}}
    with pallas_interpret():
        want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = tdpt.ResidualConvUnit(64)
    conv1, conv2 = _convs(*params)
    tm.conv1, tm.conv2 = conv1, conv2
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_vits_dpt_head_with_fused_rcu_matches_jax(jax_fused_rcu_route):
    """The vits head (features 64, out_channels 48/96/192/384): all seven
    RCUs of the suffix on the fused route in both packages."""
    from endodav_tpu.models.dpt import DPTDecoder as JDPT

    cfg = dict(in_channels=384, features=64, out_channels=(48, 96, 192, 384), num_frames=32)
    ph, pw, frames = 4, 5, 2
    rng = np.random.default_rng(9)
    taps = [(rng.standard_normal((frames, ph * pw, 384)).astype(np.float32),
             rng.standard_normal((frames, 384)).astype(np.float32)) for _ in range(4)]
    jtaps = [(jnp.asarray(a), jnp.asarray(b)) for a, b in taps]
    jm = JDPT(temporal=True, **cfg)
    with pallas_interpret():
        params = jm.init(jax.random.PRNGKey(0), jtaps, (ph, pw), frames)["params"]
        leaves, tree = jax.tree_util.tree_flatten(params)
        # fan-in scaled kernels, small biases and norms near 1: activations
        # of order 1 through the head (no saturated sigmoids)
        leaves = [(rng.standard_normal(np.shape(a)) * (np.prod(np.shape(a)[:-1]) ** -0.5
                                                       if np.ndim(a) > 1 else 0.05)
                   + (1.0 if np.ndim(a) == 1 and np.all(np.asarray(a) == 1) else 0.0))
                  .astype(np.float32) for a in leaves]
        params = jax.tree_util.tree_unflatten(tree, leaves)
        want = jm.apply({"params": params}, jtaps, (ph, pw), frames)
    tm = tdpt.DPTDecoder(**cfg)
    sd = from_jax_params({"head": jax.tree_util.tree_map(np.asarray, params)})
    tm.load_state_dict({k[len("head."):]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = tm([(torch.from_numpy(a), torch.from_numpy(b)) for a, b in taps], (ph, pw), frames)
    for s in range(4):
        np.testing.assert_allclose(got[("disp", s)].numpy(), np.asarray(want[("disp", s)]),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("features,train,flag,routed", [
    (64, False, "1", True),     # vits serving under the flag
    (128, False, "1", True),    # the widest the kernel takes
    (256, False, "1", False),   # vitl's width keeps the convolutions
    (64, True, "1", False),     # the training step never fuses
    (64, False, "0", False),    # the flag off
])
def test_rcu_route(monkeypatch, features, train, flag, routed):
    calls = []
    monkeypatch.setattr(tdpt, "fused_rcu", lambda x, c1, c2: calls.append(x.shape) or x)
    monkeypatch.setenv("ENDODAV_FUSED_RCU", flag)
    rcu = tdpt.ResidualConvUnit(features)
    with torch.no_grad():
        rcu(torch.zeros(1, 3, 4, features), train)
    assert bool(calls) == routed


def test_training_suffix_never_fuses(monkeypatch):
    """`DPTDecoder.suffix(train=True)` carries train into every fusion
    block: no RCU routes to the kernel; at serving all seven do."""
    calls = []
    monkeypatch.setattr(tdpt, "fused_rcu",
                        lambda x, c1, c2: calls.append(1) or fr.rcu_reference(
                            x, c1.weight, c1.bias, c2.weight, c2.bias))
    monkeypatch.setenv("ENDODAV_FUSED_RCU", "1")
    head = tdpt.DPTDecoder(in_channels=64, features=32, out_channels=(16, 32, 64, 64))
    rng = np.random.default_rng(2)
    taps = [(torch.from_numpy(rng.standard_normal((2, 20, 64)).astype(np.float32)),
             torch.zeros(2, 64)) for _ in range(4)]
    maps = head.prefix(taps, (4, 5))
    head.suffix(maps, 2, train=True)
    assert calls == []
    with torch.no_grad():
        head.suffix(maps, 2, train=False)
    assert len(calls) == 7
