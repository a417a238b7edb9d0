"""Port parity: the serving slice as a whole against the JAX package on
the CPU — the full-width vits EndoDAV, the weight bridge, sliding-window
inference with its stitch, and the engine/CLI around them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.eval import video_inference as tvi
from endodav_tpu_torch.models.endodav import EndoDAV
from endodav_tpu_torch.options import EndoDAVOptions
from endodav_tpu_torch.utils.convert import endodav_rules, from_jax_params

torch.set_num_threads(1)

FLAGSHIP = dict(encoder="vits", lora_type="dvlora", residual_block_indexes=(2, 5, 8, 11),
                temporal_lora=True)


@pytest.fixture(scope="module")
def jax_flagship():
    """JAX EndoDAV (flagship config, 56x70) with every param randomized."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    jm = JEndoDAV(image_shape=(56, 70), **FLAGSHIP)
    # the param tree is the same on the fused and unfused motion routes
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 56, 70, 3)))["params"]
    rng = np.random.default_rng(0)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32) for a in leaves]
    return jm, jax.tree_util.tree_unflatten(tree, leaves)


def test_from_jax_params_covers_every_leaf_once(jax_flagship):
    _, params = jax_flagship
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = {tuple(k.key for k in path) for path, _ in flat}
    hits = {}
    for _, flax_key, _ in endodav_rules():
        if flax_key in paths:
            hits[flax_key] = hits.get(flax_key, 0) + 1
    assert set(hits) == paths
    assert set(hits.values()) == {1}
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    model = EndoDAV(image_shape=(56, 70), **FLAGSHIP)
    model.load_state_dict(sd, strict=True)  # every port parameter written, none extra


def test_endodav_slice_matches_jax(jax_flagship, monkeypatch):
    """Full-width vits EndoDAV at 56x70, T=2: the JAX model on its TPU route
    (fused temporal block, LayerNorm eps 1e-5) in interpret mode against
    the port's plain versions, at test_fullmodel_parity.py's 2e-4."""
    from endodav_tpu.models import motion as jmotion

    jm, params = jax_flagship
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    video = np.random.default_rng(7).uniform(0.05, 0.95, (1, 2, 64, 80, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(video))
    model = EndoDAV(image_shape=(56, 70), **FLAGSHIP)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = model(torch.from_numpy(video))
    for s in range(4):
        g, w = got[("disp", s)].numpy(), np.asarray(want[("disp", s)])
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 2e-4, (s, np.abs(g - w).max())


def test_window_helpers_match_jax():
    from endodav_tpu.eval import video_inference as jvi

    for n in (1, 31, 32, 60, 186):
        np.testing.assert_array_equal(tvi.window_indices(n), jvi.window_indices(n))
        nw = len(jvi.window_indices(n))
        for a, b in zip(tvi.stitch_plan(n, nw), jvi.stitch_plan(n, nw)):
            np.testing.assert_array_equal(a, b)
    for hw, target in (((512, 640), (518, 644)), ((1024, 1280), (518, 518)),
                       ((256, 320), (224, 280))):
        assert tvi.keep_aspect_size(*hw, *target) == jvi.keep_aspect_size(*hw, *target)


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


@pytest.mark.parametrize("kind", ["uint8", "float255", "float01"])
def test_infer_video_depth_matches_jax(kind):
    """60 frames (3 windows) through the window path and host stitch, with
    a slot-dependent stand-in forward so that the stitch's scale/shift fits
    do real work."""
    from endodav_tpu.eval import video_inference as jvi

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (60, 40, 48, 3)).astype(np.uint8)
    if kind == "float255":
        frames = frames.astype(np.float32)
    elif kind == "float01":
        frames = frames.astype(np.float32) / 255.0
    want = jvi.infer_video_depth(_slot_forward_jax, frames, image_shape=(28, 42),
                                 chunk_windows=2)
    got = tvi.infer_video_depth(_slot_forward_torch, frames, image_shape=(28, 42),
                                chunk_windows=2, device="cpu")
    assert got.shape == want.shape == (60, 40, 48)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _opt(*args):
    return EndoDAVOptions().parse(["--no_cuda", "--depth_image_shape", "28", "42", *args])


def test_build_depth_model_merge_lora_is_exact():
    opt = _opt("--temporal_lora")
    unmerged = engine.build_depth_model(opt)
    merged = engine.build_depth_model(_opt("--temporal_lora", "--merge_lora"))
    assert not any("lora_" in k for k in merged.state_dict())
    video = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 2, 28, 42, 3))
                             .astype(np.float32))
    with torch.inference_mode():
        a, b = unmerged(video)[("disp", 0)], merged(video)[("disp", 0)]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_reference_pth_round_trip(tmp_path):
    """A reference-convention depth_model.pth loads through the engine."""
    src = engine.init_random_(EndoDAV(image_shape=(28, 42), residual_block_indexes=(2, 5, 8, 11)),
                              seed=5)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["head.scratch.refinenet4.resConfUnit1.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    torch.save(sd, tmp_path / "depth_model.pth")
    model = engine.build_depth_model(_opt("--load_weights_folder", str(tmp_path)))
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_evaluate_video_sequences_and_report():
    from endodav_tpu_torch.cli.evaluate_depth_video import report
    from endodav_tpu_torch.data.pipeline import pixel_intrinsics

    opt = _opt("--merge_lora", "--disable_residual_block")
    rng = np.random.default_rng(2)
    n, h, w = 40, 32, 40
    seq = {"colors": rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8),
           "depths": rng.uniform(5, 100, (n, h, w)).astype(np.float32),
           "poses": np.repeat(np.eye(4)[None], n, axis=0),
           "Ks": pixel_intrinsics(n, h, w), "filename": "synthetic"}
    device = engine.resolve_device(opt)
    fwd = engine.depth_window_forward(engine.build_depth_model(opt, device))
    result = engine.evaluate_video_sequences(opt, [seq], fwd, device=device)
    assert np.all(np.isfinite(result["mean_errors"])) and result["mean_errors"].shape == (7,)
    assert np.all(np.isfinite(result["mean_temporal"]))
    lines = report(result)
    assert lines[0].startswith("abs_rel=") and "tas=" in lines[0]
    assert lines[2].endswith("ms/frame")


def test_resolve_device_refuses_a_quiet_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.resolve_device(EndoDAVOptions().parse([]))
    assert engine.resolve_device(EndoDAVOptions().parse(["--no_cuda"])).type == "cpu"
