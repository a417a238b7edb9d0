"""Port parity for dedup serving, the device stitch and the engine's
serving defaults against the JAX package on the CPU: `DedupWindowForward`
in prefix and taps mode over three windows (JAX with its fused temporal
block in interpret mode), the port's dedup against its own window path,
the dedup and prefix/taps decisions, `_device_stitch`, and the vitl int8
default of `depth_window_forward`."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.eval import video_inference as tvi
from endodav_tpu_torch.models.endodav import EndoDAV, prefix_map_shapes
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

CONFIG = dict(encoder="vits", lora_type="none", residual_block_indexes=())
SHAPE = (28, 42)
FRAMES = np.random.default_rng(4).integers(0, 256, (60, 40, 48, 3)).astype(np.uint8)  # 3 windows


@pytest.fixture(scope="module")
def models():
    """The JAX EndoDAV (merged vits, 28x42) with every param randomized, and
    the port's model with the same weights."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    jm = JEndoDAV(image_shape=SHAPE, **CONFIG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, *SHAPE, 3)))["params"]
    rng = np.random.default_rng(1)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32) for a in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    model = EndoDAV(image_shape=SHAPE, **CONFIG)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model.eval()


@pytest.mark.parametrize("prefix", ["1", "0"])
def test_dedup_matches_jax(models, monkeypatch, prefix):
    """60 frames (3 windows, chunks of 2 and a trimmed 1) through dedup and
    the host stitch, prefix mode and taps mode (forced by
    ENDODAV_DEDUP_PREFIX): the port against JAX at 2e-4 in disparity."""
    from endodav_tpu.eval import video_inference as jvi
    from endodav_tpu.models import motion as jmotion

    jm, params, model = models
    monkeypatch.setenv("ENDODAV_DEDUP_PREFIX", prefix)
    monkeypatch.delenv("ENDODAV_NO_DEDUP", raising=False)
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    jdedup = jvi.DedupWindowForward(jm, {"params": params})
    dedup = tvi.DedupWindowForward(model)
    assert dedup.prefix_mode == jdedup.prefix_mode == (prefix == "1")
    with pltpu.force_tpu_interpret_mode():
        want = jvi.infer_video_depth(None, FRAMES, image_shape=SHAPE, chunk_windows=2,
                                     dedup=jdedup)
    got = tvi.infer_video_depth(None, FRAMES, image_shape=SHAPE, chunk_windows=2, device="cpu",
                                dedup=dedup)
    assert got.shape == want.shape == FRAMES.shape[:3]
    assert np.abs(got - want).max() < 2e-4, np.abs(got - want).max()


@pytest.mark.parametrize("prefix", ["1", "0"])
def test_dedup_matches_window_path(models, monkeypatch, prefix):
    """Dedup computes what the window path computes: the gathered per-frame
    results are the window path's at the same point of the graph."""
    _, _, model = models
    monkeypatch.setenv("ENDODAV_DEDUP_PREFIX", prefix)
    fwd = engine.depth_window_forward(model)
    assert fwd.dedup is None  # 6 patch tokens: the window path by default
    window = tvi.infer_video_depth(fwd, FRAMES, image_shape=SHAPE, chunk_windows=2, device="cpu")
    dedup = tvi.infer_video_depth(fwd, FRAMES, image_shape=SHAPE, chunk_windows=2, device="cpu",
                                  dedup=tvi.DedupWindowForward(model))
    np.testing.assert_allclose(dedup, window, atol=1e-5)
    monkeypatch.setenv("ENDODAV_NO_DEDUP", "1")
    off = tvi.infer_video_depth(fwd, FRAMES, image_shape=SHAPE, chunk_windows=2, device="cpu",
                                dedup=tvi.DedupWindowForward(model))
    np.testing.assert_array_equal(off, window)


def _stand_in(encoder, image_shape):
    """What the dedup decisions read of a model, without its weights."""
    return types.SimpleNamespace(encoder=encoder, image_shape=image_shape, lora_type="none",
                                 patch_hw=(image_shape[0] // 14, image_shape[1] // 14),
                                 int8_serving=False)


@pytest.mark.parametrize("encoder", ["vits", "vitl"])
@pytest.mark.parametrize("shape", [(518, 644), (224, 280)])
def test_dedup_decisions_match_jax(encoder, shape, monkeypatch):
    from endodav_tpu.eval import video_inference as jvi
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV
    from endodav_tpu.models.endodav import prefix_map_shapes as jshapes

    for name in ("ENDODAV_DEDUP", "ENDODAV_NO_DEDUP", "ENDODAV_DEDUP_PREFIX"):
        monkeypatch.delenv(name, raising=False)
    jm = JEndoDAV(encoder=encoder, image_shape=shape, lora_type="none")
    port = _stand_in(encoder, shape)
    assert tvi.dedup_wins(shape) == jvi.dedup_wins(shape)
    assert tvi.dedup_by_default(shape) == jvi.dedup_by_default(shape)
    assert prefix_map_shapes(port) == jshapes(jm)
    jdedup, dedup = jvi.DedupWindowForward(jm, None), tvi.DedupWindowForward(port)
    assert dedup.prefix_mode == jdedup.prefix_mode
    for n in (20, 64, 95, 96, 186):
        assert dedup.encode_batch_for(n) == jdedup.encode_batch_for(n)
    monkeypatch.setenv("ENDODAV_NO_DEDUP", "1")
    assert not tvi.dedup_by_default(shape) and not jvi.dedup_by_default(shape)
    monkeypatch.setenv("ENDODAV_NO_DEDUP", "0")
    monkeypatch.setenv("ENDODAV_DEDUP", "1")
    assert tvi.dedup_by_default(shape) and jvi.dedup_by_default(shape)


@pytest.mark.parametrize("n,chunks", [(60, 2), (100, 3), (20, 1)])
def test_device_stitch_matches_jax(n, chunks):
    from endodav_tpu.eval import video_inference as jvi

    rng = np.random.default_rng(n)
    nw = len(tvi.window_indices(n))
    per = -(-nw // chunks) * 32
    fh, fw = 12, 10
    depth = rng.uniform(0.2, 1.0, (per * chunks, fh, fw)).astype(np.float32)
    depth *= np.repeat(rng.uniform(0.5, 2.0, per * chunks // 32), 32)[:, None, None]
    split = np.split(depth, chunks)
    want = jvi._device_stitch([jnp.asarray(c) for c in split], nw, n, fh, fw, np.float32)
    got = tvi._device_stitch([torch.from_numpy(c) for c in split], nw, n, fh, fw)
    assert got.shape == want.shape == (n, fh, fw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_infer_video_depth_device_stitch(models):
    """stitch="device" through the window path agrees with the host stitch
    where the host's clamp of the previous tail does not bind (positive
    disparities)."""
    _, _, model = models
    fwd = engine.depth_window_forward(model)
    host = tvi.infer_video_depth(fwd, FRAMES, image_shape=SHAPE, device="cpu")
    device = tvi.infer_video_depth(fwd, FRAMES, image_shape=SHAPE, device="cpu", stitch="device")
    assert device.shape == host.shape
    np.testing.assert_allclose(device, host, atol=1e-4)
    with pytest.raises(ValueError, match="stitch"):
        tvi.infer_video_depth(fwd, FRAMES, image_shape=SHAPE, device="cpu", stitch="gpu")


def test_engine_vitl_int8_default_writes_no_env(monkeypatch):
    """depth_window_forward turns the int8 GEMMs on for the merged vitl
    graph on a copy of the model (the caller's model and the environment
    untouched), leaves vits and adapted graphs alone, and yields to an
    explicit ENDODAV_INT8 either way; 518x644 gets dedup (vitl in taps
    mode, vits in prefix mode), 224x280 does not."""
    import os

    for name in ("ENDODAV_INT8", "ENDODAV_DEDUP", "ENDODAV_NO_DEDUP", "ENDODAV_DEDUP_PREFIX"):
        monkeypatch.delenv(name, raising=False)
    vitl = _stand_in("vitl", (518, 644))
    fwd = engine.depth_window_forward(vitl)
    assert fwd.model.int8_serving and not vitl.int8_serving
    assert "ENDODAV_INT8" not in os.environ
    assert fwd.dedup is not None and not fwd.dedup.prefix_mode
    vits = _stand_in("vits", (518, 644))
    fwd = engine.depth_window_forward(vits)
    assert not fwd.model.int8_serving and fwd.dedup.prefix_mode
    adapted = _stand_in("vitl", (224, 280))
    adapted.lora_type = "dvlora"
    fwd = engine.depth_window_forward(adapted)
    assert not fwd.model.int8_serving and fwd.dedup is None
    for value in ("0", "1"):
        monkeypatch.setenv("ENDODAV_INT8", value)
        assert not engine.depth_window_forward(vitl).model.int8_serving
    assert os.environ["ENDODAV_INT8"] == "1"


def test_fast_stitch_flag():
    from endodav_tpu_torch.options import EndoDAVOptions

    assert not EndoDAVOptions().parse([]).fast_stitch
    assert EndoDAVOptions().parse(["--fast_stitch"]).fast_stitch
