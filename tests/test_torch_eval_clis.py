"""The port's Hamlyn video eval against the JAX package on the CPU.

A synthetic Hamlyn tree (two ``rectifiedNN`` sequences of 40 smooth
40x48 frames: ``image01/*.jpg`` through PIL, ``depth01/*.png`` 16-bit) in a
split directory of its own, and JAX EndoDAV weights at the shipped eval's
flags (`scripts/eval_depth_video1.sh`: ssb, no residual blocks, no conv
head; ViT input 28x42) as a reference ``depth_model.pth`` that both
packages load, each from its own folder:

* `HamlynVideos` item for item (colours and depths exactly; the
  ``max_length`` and ``pred_root`` modes);
* `cli/evaluate_depth_video_hamlyn` in model mode with ``--visualize_depth``
  against JAX's CLI on its TPU route (the fused temporal block in Pallas's
  interpreter): the per-frame errors within 1e-4 relative, the printed
  metric line within one unit of its fourth decimal, the saved depth
  ``.npy`` files within 3e-4 relative of JAX's inside the evaluation range
  (1e-3 to 150, what the metrics read) and 2e-3 beyond it: a depth is the
  reciprocal of the scaled disparity, so pixels of small disparity magnify
  the disparities' ~1e-6 difference (one pixel in 1920 reaches 1.02e-4 at
  depth 79, and 4.7e-4 at 22954);
* ``--pred_root`` on JAX's saved files, with and without
  ``--disp2depth``: both packages score the same files on the host, so
  the errors agree to 1e-9 relative;
* ``--max_length``: the first N frames of each sequence.

JAX's native image decoder is switched off so that both read through PIL.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu_torch.utils.convert import from_jax_params
from test_torch_lora_models import KEY, SHIPPED, _weights, tpu_route

torch.set_num_threads(1)

SEQS = ("rectified01", "rectified14")
N, H, W = 40, 40, 48
METRIC_RTOL, NPY_RTOL, NPY_FAR_RTOL, HOST_RTOL = 1e-4, 3e-4, 2e-3, 1e-9
FLAGS = ["--model_type", "endodav", "--eval_split", "hamlyn_video", "--eval_mono",
         "--visualize_depth", "--disable_residual_block", "--disable_conv_head",
         "--lora_type=ssb", "--depth_image_shape", "28", "42"]


def write_hamlyn_tree(root, seqs=SEQS, n=N, h=H, w=W, seed=0):
    """``<root>/data/<seq>/{image01/*.jpg, depth01/*.png}`` and
    ``<root>/splits/hamlyn_video/val_files_all.txt`` naming the sequences."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    for k, seq in enumerate(seqs):
        base = os.path.join(root, "data", seq)
        os.makedirs(os.path.join(base, "image01"))
        os.makedirs(os.path.join(base, "depth01"))
        for i in range(n):
            img = np.stack([128 + 90 * np.sin(6 * xx + 4 * yy + 0.07 * i + c + k)
                            for c in range(3)], -1) + rng.uniform(-8, 8, (h, w, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(base, "image01", f"{i:010d}.jpg"), quality=95)
            d = 60 + 40 * yy + 15 * np.cos(3 * xx + 0.05 * i)
            d[:2] = 0  # a few invalid rows, as Hamlyn's rectified borders
            Image.fromarray(d.astype(np.uint16)).save(
                os.path.join(base, "depth01", f"{i:010d}.png"))
    split = os.path.join(root, "splits", "hamlyn_video")
    os.makedirs(split)
    with open(os.path.join(split, "val_files_all.txt"), "w") as f:
        f.write("\n".join(seqs) + "\n")
    return root


@pytest.fixture(scope="module")
def hamlyn(tmp_path_factory):
    """The tree, and a weights folder for each package holding the same
    ``depth_model.pth``."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    root = str(tmp_path_factory.mktemp("hamlyn"))
    write_hamlyn_tree(root)
    jm = JEndoDAV(**SHIPPED, image_shape=(28, 42))
    var = _weights(jax.eval_shape(jm.init, KEY, jnp.zeros((1, 2, 28, 42, 3))), seed=4)
    folders = {}
    for side in ("jax", "port"):
        folders[side] = os.path.join(root, f"weights_{side}")
        os.makedirs(folders[side])
        torch.save(from_jax_params(var["params"]), os.path.join(folders[side], "depth_model.pth"))
    return root, folders


@pytest.fixture
def both_read(hamlyn, monkeypatch):
    from endodav_tpu import native
    from endodav_tpu.eval import engine as jengine

    root, _ = hamlyn
    splits = os.path.join(root, "splits")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jengine, "SPLITS_DIR", splits)
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", splits)
    return os.path.join(root, "data")


def _run_jax(args, capsys):
    from endodav_tpu.cli import evaluate_depth_video_hamlyn as jcli
    from endodav_tpu.options import EndoDAVOptions as JOptions

    capsys.readouterr()
    result = jcli.evaluate(JOptions().parse(args))
    return result, capsys.readouterr().out


def _run_port(args, capsys):
    from endodav_tpu_torch.cli import evaluate_depth_video_hamlyn as cli

    capsys.readouterr()
    result = cli.main(["--no_cuda", *args])
    return result, capsys.readouterr().out


def _metric_line(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("abs_rel="))
    return [float(v) for v in re.findall(r"=(-?[\d.]+|nan)", line)]


@pytest.fixture(scope="module")
def jax_model_run(hamlyn):
    """JAX's CLI in model mode with --visualize_depth, once a module."""
    from endodav_tpu import native
    from endodav_tpu.cli import evaluate_depth_video_hamlyn as jcli
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.options import EndoDAVOptions as JOptions

    root, folders = hamlyn
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    mp.setattr(jengine, "SPLITS_DIR", os.path.join(root, "splits"))
    try:
        with tpu_route():
            return jcli.evaluate(JOptions().parse(
                ["--data_path", os.path.join(root, "data"), *FLAGS,
                 "--load_weights_folder", folders["jax"]]))
    finally:
        mp.undo()


@pytest.mark.parametrize("mode", ["model", "max_length", "pred_root"])
def test_hamlyn_videos_match_jax(both_read, hamlyn, jax_model_run, mode):
    from endodav_tpu.data import HamlynVideos as JHamlynVideos
    from endodav_tpu_torch.data import HamlynVideos

    _, folders = hamlyn
    kw = {"model": {}, "max_length": {"max_length": 16},
          "pred_root": {"pred_root": os.path.join(folders["jax"], "eval", "hamlyn_video")}}[mode]
    got, want = HamlynVideos(both_read, list(SEQS), **kw), JHamlynVideos(both_read, list(SEQS),
                                                                          **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["filename"] == w["filename"]
        for k in g:
            if k != "filename":
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert len(g["depths"]) == (16 if mode == "max_length" else N)


def test_hamlyn_cli_model_mode_matches_jax(both_read, hamlyn, jax_model_run, capsys):
    """``scripts/eval_depth_video1.sh``'s command: errors, the printed line,
    and the saved depth files against JAX's."""
    _, folders = hamlyn
    want = jax_model_run
    got, out = _run_port(["--data_path", both_read, *FLAGS,
                          "--load_weights_folder", folders["port"]], capsys)
    assert got["all_errors"].shape == want["all_errors"].shape == (2 * N, 7)
    assert np.isfinite(want["all_errors"]).all()
    np.testing.assert_allclose(got["all_errors"], want["all_errors"], rtol=METRIC_RTOL)
    np.testing.assert_allclose(_metric_line(out), want["mean_errors"], atol=1.5e-4)
    assert got["mean_temporal"] is None and "cls: " in out
    assert "average inference time" in out and " Aligning shift and scale" in out
    for seq in SEQS:
        dirs = [os.path.join(folders[s], "eval", "hamlyn_video", seq) for s in ("port", "jax")]
        names = [sorted(os.listdir(os.path.join(d, "depth"))) for d in dirs]
        assert names[0] == names[1] == [f"{i:06d}.npy" for i in range(N)]
        for name in names[0]:
            g, w = (np.load(os.path.join(d, "depth", name)) for d in dirs)
            assert g.shape == w.shape == (H, W)
            np.testing.assert_allclose(np.clip(g, 1e-3, 150), np.clip(w, 1e-3, 150),
                                       rtol=NPY_RTOL, err_msg=f"{seq}/{name}")
            np.testing.assert_allclose(g, w, rtol=NPY_FAR_RTOL, err_msg=f"{seq}/{name}")
        assert os.path.exists(os.path.join(dirs[0], "vis.mp4")) or "mp4 export failed" in out


@pytest.mark.parametrize("disp2depth", [False, True])
def test_hamlyn_cli_pred_root_matches_jax(both_read, hamlyn, jax_model_run, disp2depth, capsys):
    """``scripts/eval_depth_video_hamlyn_npy.sh``'s command on JAX's saved
    depths: the same host arithmetic, so the errors to 1e-9."""
    _, folders = hamlyn
    args = ["--data_path", both_read, "--eval_split", "hamlyn_video", "--pred_root",
            os.path.join(folders["jax"], "eval", "hamlyn_video"),
            *(["--disp2depth"] if disp2depth else [])]
    want, jout = _run_jax(args, capsys)
    got, out = _run_port(args, capsys)
    assert got["mean_infer_ms"] is None and "average inference time" not in out
    np.testing.assert_allclose(got["all_errors"], want["all_errors"], rtol=HOST_RTOL)
    assert np.isfinite(got["all_errors"]).all()
    assert _metric_line(out) == _metric_line(jout)
    if not disp2depth:
        # re-aligning depths already aligned to the same ground truth
        np.testing.assert_allclose(got["mean_errors"], jax_model_run["mean_errors"], rtol=1e-3,
                                   atol=1e-6)


def test_hamlyn_cli_max_length(both_read, capsys):
    """``--max_length 16``: 16 frames a sequence (seeded weights)."""
    got, _ = _run_port(["--data_path", both_read, *FLAGS, "--max_length", "16"], capsys)
    assert got["all_errors"].shape == (2 * 16, 7)
    assert np.isfinite(got["mean_errors"]).all()
