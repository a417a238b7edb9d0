"""Port parity of the single-frame depth path on the CPU against the JAX
package: `infer_video_depth_single_frame` (a ragged last batch, f32 and
f16 transfer), the single-frame branch of `evaluate_video_sequences`, the
frame-level datasets (`ScaredFrames`, `HamlynFrames`, `C3VDFrames`) on
synthetic trees, `cli/evaluate_depth.evaluate` on a synthetic Hamlyn tree
(plain, ``--post_process`` and ``--post_process_blend``; metric vectors
within 1e-4 relative), and `cli/test_simple` writing its .npy and jpeg.
The two packages serve the same weights: JAX EndoDAC parameters drawn with
numpy, carried to a reference ``depth_model.pth`` by `from_jax_params`,
which both engines load.  JAX's native image decoder is switched off so
that both read the frames through PIL."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu_torch.models.endodac import EndoDAC
from endodav_tpu_torch.utils.convert import from_jax_params
from test_torch_endodac import _fan_in

torch.set_num_threads(1)

TOL = 1e-5
METRIC_RTOL = 1e-4
MODEL_ARGS = ["--model_type", "endodac", "--lora_type", "dvlora", "--disable_residual_block",
              "--depth_image_shape", "28", "28"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX EndoDAC (vits, dvlora, 28x28) variables and a folder holding them
    as a reference depth_model.pth."""
    from endodav_tpu.models.endodac import EndoDAC as JEndoDAC

    jm = JEndoDAC(backbone_size="vits", image_shape=(28, 28), lora_type="dvlora")
    var = _fan_in(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))), 21)
    folder = tmp_path_factory.mktemp("endodac_weights")
    torch.save(from_jax_params(var["params"], "endodac"), folder / "depth_model.pth")
    return jm, var, str(folder)


@pytest.fixture
def pil_reader(monkeypatch):
    from endodav_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)


def _port_opt(*args):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse(["--no_cuda", *args])


def _jax_opt(*args):
    from endodav_tpu.options import EndoDAVOptions

    return EndoDAVOptions().parse(list(args))


@pytest.mark.parametrize("transfer", [np.float32, np.float16])
def test_infer_video_depth_single_frame_matches_jax(weights, transfer):
    """11 uint8 frames in batches of 8 (the port's last batch is 3 frames,
    JAX's is padded to 8 with copies): the disparity at source size."""
    from endodav_tpu.eval.video_inference import infer_video_depth_single_frame as jinfer
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth_single_frame

    jm, var, _ = weights
    frames = np.random.default_rng(22).integers(0, 256, (11, 36, 44, 3), dtype=np.uint8)
    jitted = jax.jit(lambda b: jm.apply(var, b)[("disp", 0)])

    def jfwd(batch):
        return jitted(batch)

    jfwd.precompiled = True
    want = jinfer(jfwd, frames, transfer_dtype=transfer)
    model = EndoDAC("vits", image_shape=(28, 28), lora_type="dvlora").eval()
    model.load_state_dict(from_jax_params(var["params"], "endodac"), strict=True)
    got = infer_video_depth_single_frame(engine.depth_window_forward(model), frames,
                                         transfer_dtype=transfer, device="cpu")
    assert got.shape == want.shape == (11, 36, 44) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL if transfer == np.float32 else 1e-3, rtol=0)


def test_video_eval_single_frame_branch_matches_jax(weights):
    """`evaluate_video_sequences` with --model_type endodac: per-frame depth
    errors and TAE/TAS of a synthetic sequence against JAX's."""
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu_torch.data.pipeline import pixel_intrinsics
    from endodav_tpu_torch.eval import engine

    _, _, folder = weights
    # smooth frames and depths and a small camera motion, as chip_smoke.py's
    n, h, w = 9, 32, 40
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    t = np.arange(n)[:, None, None]
    poses = np.repeat(np.eye(4)[None], n, axis=0)
    poses[:, 0, 3] = 0.01 * np.arange(n)
    colors = np.stack([128 + 100 * np.sin(6 * xx + 4 * yy + 0.05 * t + c) for c in range(3)],
                      axis=-1).astype(np.uint8)
    depths = (40 + 30 * yy + 10 * np.cos(3 * xx + 0.03 * t)).astype(np.float32)
    seqs = [{"colors": colors, "depths": depths, "poses": poses,
             "Ks": pixel_intrinsics(n, h, w), "filename": "s0"}]
    args = [*MODEL_ARGS, "--load_weights_folder", folder]
    jopt = _jax_opt(*args)
    jmodel, jvar = jengine.build_depth_model(jopt)
    want = jengine.evaluate_video_sequences(
        jopt, seqs, jengine.depth_window_forward(jmodel, jvar, "endodac"))
    opt = _port_opt(*args)
    got = engine.evaluate_video_sequences(
        opt, seqs, engine.depth_window_forward(engine.build_depth_model(opt)))
    np.testing.assert_allclose(got["all_errors"], want["all_errors"], rtol=METRIC_RTOL)
    # TAE/TAS reproject each depth map to whole pixels of the next: on these
    # frames depths that agree to 2e-6 relative move TAE by up to 3%
    assert got["all_temporal"].shape == want["all_temporal"].shape == (8, 2)
    np.testing.assert_allclose(got["all_temporal"][:, 0], want["all_temporal"][:, 0], rtol=5e-2)
    np.testing.assert_allclose(got["all_temporal"][:, 1], want["all_temporal"][:, 1], atol=1e-3)


# ---------------------------------------------------------------- datasets


def _write_endovis(root, rng):
    import cv2

    folder = "dataset7/keyframe4"  # dataset 7 < 8: under train/
    base = os.path.join(root, "train", folder, "data")
    for sub in ("left", "right", "scene_points", "frame_data"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for i in range(5):
        img = rng.integers(0, 255, (64, 80, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(base, "left", f"{i:010d}.png"), img)
        cv2.imwrite(os.path.join(base, "right", f"{i:010d}.png"), img[::-1])
        depth = rng.uniform(20, 120, (64, 80)).astype(np.float32)
        cv2.imwrite(os.path.join(base, "scene_points", f"scene_points{i:06d}.tiff"),
                    np.stack([depth] * 3, axis=-1))
        with open(os.path.join(base, "frame_data", f"frame_data{i:06d}.json"), "w") as f:
            json.dump({"camera-pose": np.eye(4).tolist()}, f)
    return folder


def _write_hamlyn(root, rng, seqs=("rectified05", "rectified15"), shape=(96, 120)):
    import cv2

    for seq in seqs:
        for sub in ("image01", "depth01"):
            os.makedirs(os.path.join(root, seq, sub), exist_ok=True)
        for i in range(3):
            cv2.imwrite(os.path.join(root, seq, "image01", f"{i:07d}.jpg"),
                        rng.integers(0, 255, (*shape, 3), dtype=np.uint8))
            cv2.imwrite(os.path.join(root, seq, "depth01", f"{i:07d}.png"),
                        rng.integers(20, 150, shape, dtype=np.uint16))


def _same_items(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=str(k))
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("is_train", [False, True])
def test_scared_frames_match_jax(tmp_path, pil_reader, is_train):
    """Every key of an item (pyramid, jittered pyramid, depth, K, stereo T)
    as JAX's; in train mode the same seed draws the same flips and jitter."""
    from endodav_tpu.data.scared import ScaredFrames as JScaredFrames
    from endodav_tpu_torch.data.scared import ScaredFrames

    folder = _write_endovis(str(tmp_path), np.random.default_rng(24))
    lines = [f"{folder}\t{i}\tl" for i in (1, 2, 3)] + [f"{folder} 2 r"]
    kw = dict(height=32, width=40, frame_idxs=(0, -1, 1, "s"), is_train=is_train, seed=5)
    got, want = ScaredFrames(str(tmp_path), lines, **kw), JScaredFrames(str(tmp_path), lines, **kw)
    assert len(got) == len(want) == 4
    for i in range(4):
        _same_items(got[i], want[i])


def test_hamlyn_and_c3vd_frames_match_jax(tmp_path, pil_reader):
    """Hamlyn (a sequence above 13 cropped) and C3VD items as JAX's."""
    import cv2

    from endodav_tpu.data.c3vd import C3VDFrames as JC3VD
    from endodav_tpu.data.hamlyn import HamlynFrames as JHamlyn
    from endodav_tpu_torch.data.c3vd import C3VDFrames
    from endodav_tpu_torch.data.hamlyn import HamlynFrames

    rng = np.random.default_rng(25)
    hamlyn = str(tmp_path / "hamlyn")
    _write_hamlyn(hamlyn, rng, shape=(300, 600))
    c3vd = tmp_path / "c3vd" / "cecum_t1_a"
    os.makedirs(c3vd)
    for i in range(2):
        cv2.imwrite(str(c3vd / f"{i:04d}_color.png"),
                    rng.integers(0, 255, (960, 1200, 3), dtype=np.uint8))
        cv2.imwrite(str(c3vd / f"{i:04d}_depth.tiff"),
                    rng.integers(0, 65535, (960, 1200), dtype=np.uint16))
    for port, jax_cls, root in ((HamlynFrames, JHamlyn, hamlyn),
                                (C3VDFrames, JC3VD, str(tmp_path / "c3vd"))):
        got, want = port(root, 32, 40), jax_cls(root, 32, 40)
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            _same_items(got[i], want[i])
    assert HamlynFrames(hamlyn, 32, 40)[3]["depth_gt"].shape == (300, 410, 1)


# ---------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("flag", [None, "--post_process", "--post_process_blend"])
def test_evaluate_depth_matches_jax(weights, tmp_path, pil_reader, flag, capsys):
    """`cli/evaluate_depth.evaluate` on a synthetic Hamlyn tree: the mean
    metric vector within 1e-4 relative of JAX's; --post_process keeps the
    plain result (the reference's discarded flipped pass)."""
    from endodav_tpu.cli import evaluate_depth as jed
    from endodav_tpu_torch.cli import evaluate_depth as ed

    _, _, folder = weights
    root = str(tmp_path / "hamlyn")
    _write_hamlyn(root, np.random.default_rng(26), seqs=("rectified05",))
    args = [*MODEL_ARGS, "--eval_split", "hamlyn", "--data_path", root, "--height", "64",
            "--width", "80", "--load_weights_folder", folder] + ([flag] if flag else [])
    want = jed.evaluate(_jax_opt(*args))
    got = ed.evaluate(_port_opt(*args))
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    out = capsys.readouterr().out
    assert "Scaling ratios" in out and "cls: [" in out and "ms/frame" in out
    if flag == "--post_process":
        plain = ed.evaluate(_port_opt(*args[:-1]))
        np.testing.assert_allclose(got, plain, rtol=1e-6)


@pytest.mark.parametrize("model_type", ["endodac", "afsfm"])
def test_test_simple_writes_npy_and_jpeg(tmp_path, model_type):
    """`cli/test_simple` on a folder of two PNGs: `<name>_disp.npy` holds
    `predict_disparity`'s disparity at the source size, and the jpeg
    decodes to the same size."""
    from PIL import Image

    from endodav_tpu_torch.cli import test_simple as ts
    from endodav_tpu_torch.eval import engine

    rng = np.random.default_rng(27)
    for name in ("a", "b"):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(
            tmp_path / f"{name}.png")
    opt = ts.parse_args(["--image_path", str(tmp_path), "--model_type", model_type,
                         "--depth_image_shape", "28", "28", "--no_cuda"])
    ts.test_simple(opt)
    model = engine.build_depth_model(opt)
    img = np.asarray(Image.open(tmp_path / "a.png"))
    disp = ts.predict_disparity(model, img).numpy()
    saved = np.load(tmp_path / "a_disp.npy")
    assert saved.shape == disp.shape == (64, 96)
    np.testing.assert_allclose(saved, disp, atol=1e-6)
    assert np.all((saved > 0) & (saved < 1))
    with Image.open(tmp_path / "b_disp.jpeg") as jpeg:
        assert jpeg.size == (96, 64)
