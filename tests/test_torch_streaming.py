"""The port's `DepthStreamer` on the CPU: against the port's offline
`infer_video_depth(..., stitch="host")` for every stream length of
`tests/test_streaming.py` (1e-4, that file's bound: the per-window resize
against the whole-video resize reorders f32 sums, which the scale/shift
fit amplifies), float [0, 255] frames, the finality cadence, bounded
memory and the guards; and in dedup mode on a tiny EndoDAV (28x28):
against JAX's `DepthStreamer` at the JAX streaming test's init weights
(1e-4), carried across by `from_jax_params`, with JAX's fused temporal
block in interpret mode (the function the port serves), and with every
weight random against the port's offline dedup path (1e-4)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.eval import video_inference as tvi
from endodav_tpu_torch.eval.streaming import DepthStreamer
from endodav_tpu_torch.models.endodav import EndoDAV
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


SRC_HW = (64, 80)
IMAGE_SHAPE = (56, 70)  # keep_aspect of 64x80


def _fake_forward(win):
    """EndoDAV's stand-in: [C, T, th, tw, 3] -> [C*T, h', w', 1], depending
    on content and slot position (a stitch slip changes values)."""
    c, t = win.shape[:2]
    x = win[:, :, ::7, ::7, :]
    d = torch.tanh(x[..., 0] * 1.7 + x[..., 1] - 0.3 * x[..., 2])
    d = d * (1.0 + 0.1 * torch.arange(t, dtype=d.dtype)[None, :, None, None])
    d = d * 0.5 + 0.5
    return d.reshape(c * t, d.shape[2], d.shape[3], 1)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *SRC_HW, 3), dtype=np.uint8)


def _stream(streamer, frames):
    out, max_buf = [], 0
    for f in frames:
        out.extend(streamer.push(f))
        max_buf = max(max_buf, streamer.frames_buffered)
    out.extend(streamer.flush())
    return np.stack(out, axis=0), max_buf


@pytest.mark.parametrize("n", [5, 32, 33, 54, 76, 110])
def test_streaming_matches_offline(n):
    frames = _frames(n)
    ref = tvi.infer_video_depth(_fake_forward, frames, image_shape=IMAGE_SHAPE, chunk_windows=2,
                                device="cpu", stitch="host")
    got, max_buf = _stream(DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cpu"), frames)
    assert got.shape == ref.shape == (n, *SRC_HW)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert max_buf <= 64  # fewer than 2 * INFER_LEN source frames held


def test_streaming_float_255_frames_match_offline():
    """Float frames in [0, 255] take the offline path's /255 heuristic."""
    frames = _frames(40).astype(np.float32)
    ref = tvi.infer_video_depth(_fake_forward, frames, image_shape=IMAGE_SHAPE, chunk_windows=2,
                                device="cpu", stitch="host")
    got, _ = _stream(DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cpu"), frames)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert tvi.frame_scale(frames / 255.0) == 1.0 and tvi.frame_scale(frames) == 255.0


def test_streaming_finality_cadence():
    """Window k finalizes its frames when source frame 22k + 31 arrives."""
    streamer = DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cpu")
    emitted_at, total = {}, 0
    for i, f in enumerate(_frames(76, seed=1)):
        new = streamer.push(f)
        if new:
            emitted_at[i] = len(new)
            total += len(new)
    tail = streamer.flush()
    assert emitted_at == {31: 24, 53: 22, 75: 22}  # INFER_LEN - INTERP_LEN, then the step
    assert total + len(tail) == 76


def test_streaming_guards():
    streamer = DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cpu")
    assert streamer.flush() == []
    with pytest.raises(RuntimeError, match="after flush"):
        streamer.push(_frames(1)[0])
    with pytest.raises(RuntimeError, match="twice"):
        streamer.flush()
    streamer = DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cpu")
    streamer.push(_frames(1)[0])
    with pytest.raises(ValueError, match="frame size"):
        streamer.push(np.zeros((32, 32, 3), np.uint8))


def test_streaming_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DepthStreamer(_fake_forward, IMAGE_SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cuda")
    assert DepthStreamer(_fake_forward, IMAGE_SHAPE, device="cpu").device.type == "cpu"


def test_window_chunk_forward_is_the_offline_chunk():
    """The one-window chunk forward returns [T, fh, fw]: for a clip of one
    window (20 frames, the last repeated), the offline path's rows."""
    frames = _frames(20)
    th, tw = tvi.keep_aspect_size(*SRC_HW, *IMAGE_SHAPE)
    win = frames[np.minimum(np.arange(32), 19)]
    win = tvi.upload_resized(win, tvi.frame_scale(win), th, tw, torch.device("cpu"))
    out = tvi.window_chunk_forward(_fake_forward, *SRC_HW)(win[None])
    assert out.shape == (32, *SRC_HW)
    ref = tvi.infer_video_depth(_fake_forward, frames, image_shape=IMAGE_SHAPE, chunk_windows=1,
                                device="cpu")
    np.testing.assert_allclose(out[:20].numpy(), ref, atol=1e-6)


def _port_model(params):
    model = EndoDAV(image_shape=(28, 28), num_frames=32)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return model.eval()


@pytest.fixture(scope="module")
def tiny_models():
    """JAX's EndoDAV of the JAX streaming test (28x28, its init weights)
    and the port's with the same weights."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    jm = JEndoDAV(image_shape=(28, 28), num_frames=32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 28, 28, 3)))["params"]
    return jm, params, _port_model(params)


@pytest.mark.parametrize("n", [33, 54])
def test_streaming_dedup_matches_jax(tiny_models, monkeypatch, n):
    """Dedup streaming (one encode per pushed frame, the window head per
    fired window), prefix mode, against JAX's streamer over the same
    frames.  The init weights are those of the JAX streaming test: with
    every weight random, JAX's own streamer and offline path already
    differ by 3e-4 on this CPU (its convolutions at batch 1 and 32)."""
    from endodav_tpu.eval import streaming as jstreaming
    from endodav_tpu.eval import video_inference as jvi
    from endodav_tpu.models import motion as jmotion

    jm, params, model = tiny_models
    monkeypatch.delenv("ENDODAV_NO_DEDUP", raising=False)
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    frames = np.random.default_rng(7).integers(0, 255, (n, 32, 32, 3), dtype=np.uint8)
    jdedup = jvi.dedup_window_forward(jm, {"params": params})
    dedup = tvi.DedupWindowForward(model)
    assert dedup.prefix_mode == jdedup.prefix_mode
    with pallas_interpret():
        want, _ = _stream(jstreaming.DepthStreamer(None, image_shape=(28, 28), dedup=jdedup),
                          frames)
    got, max_buf = _stream(DepthStreamer(None, (28, 28), dedup=dedup, device="cpu"), frames)
    assert got.shape == want.shape == (n, 32, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert max_buf <= 64


@pytest.mark.parametrize("prefix", ["1", "0"])
def test_streaming_dedup_matches_offline_dedup(tiny_models, monkeypatch, prefix):
    """With every weight random (fan-in scaled, so the temporal modules
    and both halves of the head move the output), dedup streaming in
    prefix and taps mode equals the port's offline dedup path over three
    windows (oneDNN's reduced-precision f32 convolutions off, as in the
    training tests)."""
    monkeypatch.setenv("ENDODAV_DEDUP_PREFIX", prefix)
    _, params, _ = tiny_models
    rng = np.random.default_rng(1)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * (np.prod(np.shape(a)[:-1]) ** -0.5
                                                   if np.ndim(a) > 1 else 0.05)
               + (1.0 if np.ndim(a) == 1 and np.all(np.asarray(a) == 1) else 0.0))
              .astype(np.float32) for a in leaves]
    dedup = tvi.DedupWindowForward(_port_model(jax.tree_util.tree_unflatten(tree, leaves)))
    assert dedup.prefix_mode == (prefix == "1")
    frames = np.random.default_rng(8).integers(0, 255, (54, 32, 32, 3), dtype=np.uint8)
    with torch.backends.mkldnn.flags(enabled=False):
        got, _ = _stream(DepthStreamer(None, (28, 28), dedup=dedup, device="cpu"), frames)
        want = tvi.infer_video_depth(None, frames, image_shape=(28, 28), chunk_windows=2,
                                     device="cpu", dedup=dedup)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
