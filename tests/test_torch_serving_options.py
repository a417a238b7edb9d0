"""The serving options of the port's pipeline against the JAX package on
the CPU: ``transfer_dtype`` and ``sequential`` of `infer_video_depth`,
``transfer_dtype`` of `DepthStreamer`, and a bf16 `EndoDAV` served
through both.

At f32, with slot-dependent stand-in forwards (the scale/shift fits do
real work): ``transfer_dtype=np.float16`` against JAX's on the host and
the device stitch within 1e-3 (two f16 roundings of disparity in [0.5,
1), 2^-11 each, through the stitch's scale and shift), and against the
port's own f32 transfer within the same bound; ``sequential=True``
against JAX's sequential run (1e-4, the window path's bound in
`tests/test_torch_port_serving.py`) and equal to the port's batched run
with the same stitch.

bf16: the tiny EndoDAV of the streaming tests (28x28, full vits widths)
at JAX's init weights, built with ``dtype=bfloat16`` in both packages,
through the window and dedup paths, both stitches, f16 transfer and
``sequential``, and through `DepthStreamer` with f16 transfer, against
JAX's pipeline at bf16: the stitched disparity within the whole-model
bf16 bounds of `tests/test_torch_bf16_serving.py` (2.5e-2 max, 4e-3
mean).  JAX's motion modules run their fused Pallas block in interpret
mode (the function the port serves).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.eval import video_inference as tvi
from endodav_tpu_torch.eval.streaming import DepthStreamer
from endodav_tpu_torch.models.endodav import EndoDAV
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

F16_TOL = 1e-3


@contextlib.contextmanager
def pallas_interpret():
    """Every `pl.pallas_call` of the JAX kernels on Pallas's generic
    interpreter (`interpret=True`: the kernel body as plain JAX ops)."""
    real = pl.pallas_call
    pl.pallas_call = lambda *a, **k: real(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        pl.pallas_call = real


def _slot_forward_torch(win):
    c, t = win.shape[:2]
    slot = torch.arange(t, dtype=win.dtype).repeat(c)[:, None, None, None]
    x = win.reshape(c * t, *win.shape[2:]).mean(-1, keepdim=True)
    return torch.sigmoid(x * (1.0 + 0.05 * slot) - 0.3)[:, ::2, ::2]


def _slot_forward_jax(win):
    c, t = win.shape[:2]
    slot = jnp.tile(jnp.arange(t, dtype=win.dtype), c)[:, None, None, None]
    x = win.reshape(c * t, *win.shape[2:]).mean(-1, keepdims=True)
    return jax.nn.sigmoid(x * (1.0 + 0.05 * slot) - 0.3)[:, ::2, ::2]


def _frames(n, hw=(40, 48), seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3)).astype(np.uint8)


@pytest.mark.parametrize("stitch", ["host", "device"])
def test_transfer_dtype_f16_matches_jax(stitch):
    """60 frames (3 windows), f16 transfer: disparity back in JAX's dtype
    (float64 from the host stitch, f32 from the device stitch), within f16
    rounding of JAX's and of the port's own f32 transfer, and not equal to
    the latter (the f16 copy took place)."""
    from endodav_tpu.eval import video_inference as jvi

    frames = _frames(60)
    kw = dict(image_shape=(28, 42), chunk_windows=2, stitch=stitch)
    want = jvi.infer_video_depth(_slot_forward_jax, frames, transfer_dtype=np.float16, **kw)
    got = tvi.infer_video_depth(_slot_forward_torch, frames, device="cpu",
                                transfer_dtype=np.float16, **kw)
    f32 = tvi.infer_video_depth(_slot_forward_torch, frames, device="cpu", **kw)
    assert got.dtype == want.dtype == (np.float64 if stitch == "host" else np.float32)
    assert got.shape == want.shape == (60, 40, 48)
    np.testing.assert_allclose(got, want, atol=F16_TOL)
    np.testing.assert_allclose(got, f32, atol=F16_TOL)
    assert not np.array_equal(got, f32)


@pytest.mark.parametrize("stitch", ["host", "device"])
def test_sequential_matches_jax_and_batched(stitch):
    """``sequential=True`` (one window a chunk, each copied to the host
    before the next) against JAX's sequential run, and equal to the port's
    batched run with the same stitch; a dedup forward is ignored."""
    from endodav_tpu.eval import video_inference as jvi

    class _NoDedup:
        def encode(self, batch):
            raise AssertionError("sequential serving must not take the dedup path")

    frames = _frames(76, seed=4)
    kw = dict(image_shape=(28, 42), stitch=stitch)
    want = jvi.infer_video_depth(_slot_forward_jax, frames, chunk_windows=1, sequential=True,
                                 **kw)
    got = tvi.infer_video_depth(_slot_forward_torch, frames, chunk_windows=3, device="cpu",
                                sequential=True, dedup=_NoDedup(), **kw)
    batched = tvi.infer_video_depth(_slot_forward_torch, frames, chunk_windows=2,
                                    device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got, batched)


def _stream(streamer, frames):
    out = []
    for f in frames:
        out.extend(streamer.push(f))
    out.extend(streamer.flush())
    return np.stack(out, axis=0)


def test_streamer_transfer_f16_matches_jax():
    """The window-path streamer with f16 transfer against JAX's (same
    stand-in forward) within f16 rounding, and against the port's f32
    streamer."""
    from endodav_tpu.eval import streaming as jstreaming

    frames = _frames(54, hw=(32, 40), seed=5)
    want = _stream(jstreaming.DepthStreamer(_slot_forward_jax, (28, 28),
                                            transfer_dtype=np.float16), frames)
    got = _stream(DepthStreamer(_slot_forward_torch, (28, 28), device="cpu",
                                transfer_dtype=np.float16), frames)
    f32 = _stream(DepthStreamer(_slot_forward_torch, (28, 28), device="cpu"), frames)
    assert got.dtype == want.dtype and got.shape == want.shape == (54, 32, 40)
    np.testing.assert_allclose(got, want, atol=F16_TOL)
    np.testing.assert_allclose(got, f32, atol=F16_TOL)
    assert not np.array_equal(got, f32)


# ---------------------------------------------------------------- bf16 models

BF16_MAX, BF16_MEAN = 2.5e-2, 4e-3


@pytest.fixture(scope="module")
def tiny_bf16():
    """The streaming tests' tiny EndoDAV (28x28) at JAX's init weights: the
    JAX model with dtype=bfloat16 and its params, and the port's f32 model
    on the same weights with its bf16 clone."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    jm = JEndoDAV(image_shape=(28, 28), num_frames=32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 28, 28, 3)))["params"]
    model = EndoDAV(image_shape=(28, 28), num_frames=32)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    jb = JEndoDAV(image_shape=(28, 28), num_frames=32, dtype=jnp.bfloat16)
    return jb, params, model.eval().clone(dtype=torch.bfloat16)


@pytest.fixture
def jax_tpu_route(monkeypatch):
    from endodav_tpu.models import motion as jmotion

    monkeypatch.delenv("ENDODAV_NO_DEDUP", raising=False)
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")


def _bf16_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= BF16_MAX and d.mean() <= BF16_MEAN, (d.max(), d.mean())


@pytest.mark.parametrize("path,stitch,transfer,sequential", [
    ("window", "host", np.float32, True),    # the TPU benchmark's baseline leg
    ("window", "device", np.float16, False),
    ("dedup", "host", np.float16, False),
    ("dedup", "device", np.float16, False),  # the TPU benchmark's headline leg
])
def test_bf16_model_serves_like_jax(tiny_bf16, jax_tpu_route, path, stitch, transfer,
                                    sequential):
    """`infer_video_depth` over 54 frames (3 windows) with the bf16 model,
    through `engine.depth_window_forward` (window path) or a
    `DedupWindowForward` of it, against JAX's bf16 pipeline."""
    from endodav_tpu.eval import video_inference as jvi

    jb, params, model = tiny_bf16
    frames = np.random.default_rng(7).integers(0, 255, (54, 32, 32, 3), dtype=np.uint8)
    kw = dict(image_shape=(28, 28), chunk_windows=1 if sequential else 2, stitch=stitch,
              transfer_dtype=transfer, sequential=sequential)
    if path == "dedup":
        jdedup = jvi.dedup_window_forward(jb, {"params": params})
        dedup, fwd, jfwd = tvi.DedupWindowForward(model), None, None
        assert dedup.prefix_mode == jdedup.prefix_mode
    else:
        jdedup, dedup = None, None
        fwd = engine.depth_window_forward(model)
        assert fwd.dedup is None  # 2x2 patch tokens: the window path

        def jfwd(win):
            return jb.apply({"params": params}, win)[("disp", 0)]

    with pallas_interpret():
        want = jvi.infer_video_depth(jfwd, frames, dedup=jdedup, **kw)
    got = tvi.infer_video_depth(fwd, frames, device="cpu", dedup=dedup, **kw)
    _bf16_close(got, want)


def test_bf16_model_streams_like_jax(tiny_bf16, jax_tpu_route):
    """`DepthStreamer` in dedup mode with the bf16 model and f16 transfer
    against JAX's streamer at bf16 over 54 frames; the per-frame encode
    results stay bf16."""
    from endodav_tpu.eval import streaming as jstreaming
    from endodav_tpu.eval import video_inference as jvi

    jb, params, model = tiny_bf16
    frames = np.random.default_rng(8).integers(0, 255, (54, 32, 32, 3), dtype=np.uint8)
    jdedup = jvi.dedup_window_forward(jb, {"params": params})
    with pallas_interpret():
        want = _stream(jstreaming.DepthStreamer(None, image_shape=(28, 28), dedup=jdedup,
                                                transfer_dtype=np.float16), frames)
    streamer = DepthStreamer(None, (28, 28), dedup=tvi.DedupWindowForward(model), device="cpu",
                             transfer_dtype=np.float16)
    assert streamer.push(frames[0]) == []
    assert {t.dtype for t in streamer._encoded[0]} == {torch.bfloat16}
    got = _stream(streamer, frames[1:])
    _bf16_close(got, want)
