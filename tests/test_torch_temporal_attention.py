"""Port parity of temporal attention and RoPE on the CPU against the JAX
package: `kernels/temporal_attention.py` (its plain version, which the
wrapper runs for CPU tensors) against JAX's Pallas kernel in interpret
mode (Pallas's generic interpreter) at `tests/test_kernels.py`'s shapes (2e-5, that file's bound; bf16
1e-2), its gradient (the port's autograd.Function) against JAX's `_bwd`
(1e-4), RoPE motion modules in serving and training mode (1e-5), the
RoPE tables, and a whole RoPE EndoDAV whose weights `from_jax_params`
carries across, every leaf once.  Inputs come from numpy seeds."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.kernels.temporal_attention import temporal_attention
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


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dh,h", [(8, 8), (24, 8), (64, 4)])
def test_temporal_attention_matches_jax_kernel(dh, h):
    from endodav_tpu.kernels import temporal_attention as jta

    q, k, v = _qkv((13, 32, h, dh), seed=dh)  # 13 rows: not a multiple of JAX's 8
    with pallas_interpret():
        want = np.asarray(jta._forward(*map(jnp.asarray, (q, k, v)), dh ** -0.5))
    got = temporal_attention(*map(torch.from_numpy, (q, k, v)), dh ** -0.5).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_temporal_attention_bf16_matches_jax_kernel():
    """bf16 inputs, p rounded to bf16 before PV on both sides."""
    from endodav_tpu.kernels import temporal_attention as jta

    q, k, v = _qkv((9, 16, 8, 24), seed=5)
    with pallas_interpret():
        want = jta._forward(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 24 ** -0.5)
    got = temporal_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2)


def test_temporal_attention_gradient_matches_jax_bwd():
    from endodav_tpu.kernels.temporal_attention import _bwd

    q, k, v = _qkv((3, 8, 2, 16), seed=7)
    g = np.random.default_rng(8).standard_normal((3, 8, 2, 16)).astype(np.float32)
    want = _bwd(16 ** -0.5, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = temporal_attention(*ts)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


def test_rope_tables_match_jax():
    from endodav_tpu.models.motion import rope_tables as jrope_tables
    from endodav_tpu_torch.models.motion import rope_tables

    for dim, max_len in ((64, 32), (384, 16)):
        for a, b in zip(rope_tables(dim, max_len), jrope_tables(dim, max_len)):
            np.testing.assert_array_equal(a, b)


def _randomize(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * scale).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("train", [False, True])
def test_rope_temporal_module_matches_jax(train):
    """A RoPE module takes the unfused route (LayerNorm eps 1e-6, no pe, q
    and k rotated) in serving and in training mode, in both packages."""
    from endodav_tpu.models.motion import TemporalModule as JTemporal
    from endodav_tpu_torch.models.motion import TemporalModule

    rng = np.random.default_rng(11)
    frames = 8
    x = rng.standard_normal((2 * frames, 3, 5, 64)).astype(np.float32)
    jm = JTemporal(in_channels=64, zero_initialize=False, pos_embedding_type="rope",
                   lora_variant="dvlora", lora_alpha=4.0)
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), frames)["params"], 12)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), frames, train=train))
    tm = TemporalModule(64, pos_embedding_type="rope", lora_variant="dvlora", lora_alpha=4.0)
    sd = {k[len("head.motion_modules.0."):]: v for k, v in from_jax_params(
        {"head": {"motion_modules_0": jax.tree_util.tree_map(np.asarray, p)}}).items()}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), frames, train=train).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rope_module_reaches_the_kernel_wrapper_at_serving(monkeypatch):
    """Serving, RoPE: both attention sub-blocks call temporal_attention
    (APE serving takes the fused block instead)."""
    from endodav_tpu_torch.models import motion

    calls = []
    real = motion.temporal_attention
    monkeypatch.setattr(motion, "temporal_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 2, 3, 64))
                         .astype(np.float32))
    with torch.no_grad():
        motion.TemporalModule(64, pos_embedding_type="rope")(x, 4)
    assert calls == [(12, 4, 8, 8)] * 2  # rows = 2 clips x 2x3 pixels
    with pytest.raises(ValueError, match="pos_embedding_type"):
        motion.TemporalModule(64, pos_embedding_type="sine")


def test_rope_endodav_matches_jax():
    """A whole RoPE EndoDAV (28x28, 8 frames): from_jax_params writes
    every JAX leaf once into the port's state dict (RoPE adds none), and
    the disparities agree to 1e-4."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV
    from endodav_tpu_torch.models.endodav import EndoDAV

    cfg = dict(image_shape=(28, 28), pos_embedding_type="rope", lora_type="none")
    video = np.random.default_rng(3).uniform(0, 1, (1, 8, 32, 32, 3)).astype(np.float32)
    jm = JEndoDAV(**cfg)
    p = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video))["params"], 4)
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(video))
    n_leaves = len(jax.tree_util.tree_leaves(p))
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, p))
    assert len(sd) == n_leaves
    tm = EndoDAV(**cfg).eval()
    result = tm.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    with torch.no_grad():
        got = tm(torch.from_numpy(video))
    for s in range(4):
        np.testing.assert_allclose(got[("disp", s)].numpy(), np.asarray(want[("disp", s)]),
                                   atol=1e-4, rtol=1e-4)
