"""Three shipped scripts that run no training, on the port against the JAX
package on the CPU, each with the script's flags exactly (the model's
input cut to 28x42, the frames to 64x96, the trees to a few sequences):

* `scripts/eval_depth_video.sh`: the default EndoDAV (dvlora, residual
  blocks 2, 5, 8 and 11, the conv head) through
  `evaluate_depth_video_pose` on a SCARED tree, then
  `evaluate_depth_video_hamlyn` on a Hamlyn tree, both on one weights
  folder that JAX's `save_components` wrote (the depth model and the pose
  stack); JAX's motion modules on their TPU route (the fused temporal
  block in Pallas's interpreter), as the port serves;
* `scripts/eval_depth_video_scared_npy.sh`: `evaluate_depth_video
  --pred_root` on saved depth files, no model;
* `scripts/export_gt_depth.sh`: `export_gt --split endovis_video --useage
  eval` with the root wrapper's ``--what depth`` (`export_gt_depth.py:6`),
  into ``endovis_video/gt_depths.npz`` of a temporary split directory for
  each package.

Tolerances as `tests/test_torch_train_loop.py` and
`tests/test_torch_eval_clis.py`: per-frame depth errors through a model
within 1e-4 relative, TAE and TAS 5%, ATE, RE and the intrinsics 1e-4;
the re-score, which both packages do on the host from the same files,
1e-9 relative; the exported depths exactly.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_eval_clis import write_hamlyn_tree
from test_torch_endodac import _fan_in
from test_torch_lora_models import KEY, _weights, tpu_route
from test_torch_tools import _jax_main
from test_torch_train_loop import (METRIC_RTOL, SEQ_VAL, TEMPORAL_RTOL, jax_opt, port_opt,
                                   write_tree)

torch.set_num_threads(1)

HOST_RTOL = 1e-9
SMALL = ["--height", "64", "--width", "96", "--depth_image_shape", "28", "42"]
SCARED_N, HAMLYN_SEQ, HAMLYN_N = 12, "rectified01", 12
# scripts/eval_depth_video.sh:7-9 and :11-13
POSE_EVAL = ["--model_type", "endodav", "--eval_split", "scared_video", "--eval_mono"]
HAMLYN_EVAL = ["--model_type", "endodav", "--eval_split", "hamlyn_video", "--eval_mono"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """`write_tree`'s SCARED sequences and one Hamlyn sequence, 12 frames
    each (one window), under one root (``data/`` and ``splits/``)."""
    root = write_tree(str(tmp_path_factory.mktemp("scripts")), n=SCARED_N)
    write_hamlyn_tree(root, seqs=(HAMLYN_SEQ,), n=HAMLYN_N)
    return root


@pytest.fixture
def both_read(trees, monkeypatch):
    """Both packages on the trees' split directory, JAX through PIL."""
    from endodav_tpu import native
    from endodav_tpu.eval import engine as jengine

    splits = os.path.join(trees, "splits")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jengine, "SPLITS_DIR", splits)
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", splits)
    return os.path.join(trees, "data")


@pytest.fixture(scope="module")
def default_weights(tmp_path_factory):
    """A folder of JAX's default EndoDAV (the depth model of
    `scripts/eval_depth_video.sh`) and the pose stack, numpy weights on
    JAX's shapes, written by JAX's `save_components`."""
    from endodav_tpu.models.decoders import IntrinsicsHead, PoseDecoder
    from endodav_tpu.models.endodav import EndoDAV
    from endodav_tpu.models.resnet import ResNetEncoder
    from endodav_tpu.utils import checkpoint as jckpt

    depth = EndoDAV(image_shape=(28, 42), residual_block_indexes=(2, 5, 8, 11), r=4,
                    lora_type="dvlora", conv_head=True)
    shapes = {
        "depth_model": jax.eval_shape(depth.init, KEY, jnp.zeros((1, 2, 28, 42, 3))),
        "pose_encoder": jax.eval_shape(ResNetEncoder(18, num_input_images=2).init, KEY,
                                       jnp.zeros((1, 64, 96, 6))),
        "pose": jax.eval_shape(PoseDecoder(num_frames_to_predict_for=2).init, KEY,
                               [jnp.zeros((1, 2, 3, 512))]),
        "intrinsics_head": jax.eval_shape(IntrinsicsHead().init, KEY,
                                          jnp.zeros((1, 4, 6, 256)), 96, 64)}
    variables = {"depth_model": _weights(shapes["depth_model"], seed=5),
                 **{k: _fan_in(v, seed=6 + i) for i, (k, v) in enumerate(shapes.items())
                    if k != "depth_model"}}
    folder = str(tmp_path_factory.mktemp("default_weights"))
    jckpt.save_components(folder, variables, metadata={
        "height": 64, "width": 96, "use_stereo": False, "dash_phase2": False})
    return folder


def test_eval_depth_video_sh_matches_jax(both_read, default_weights):
    """Both commands of `scripts/eval_depth_video.sh` on the default model:
    the SCARED pose eval's per-frame depth errors, TAE/TAS and pose, then
    the Hamlyn eval's per-frame errors, each against JAX's CLI."""
    from endodav_tpu.cli import evaluate_depth_video_hamlyn as jhamlyn
    from endodav_tpu.cli import evaluate_depth_video_pose as jpose
    from endodav_tpu_torch.cli import evaluate_depth_video_hamlyn as hamlyn
    from endodav_tpu_torch.cli import evaluate_depth_video_pose as pose

    weights = ["--data_path", both_read, "--load_weights_folder", default_weights, *SMALL]
    with tpu_route():
        want = jpose.evaluate(jax_opt(*POSE_EVAL, *weights))
        want_h = jhamlyn.evaluate(jax_opt(*HAMLYN_EVAL, *weights))
    opt = port_opt(*POSE_EVAL, *weights)
    assert opt.lora_type == "dvlora" and opt.residual_block_indexes == [2, 5, 8, 11]
    assert not opt.disable_residual_block and not opt.disable_conv_head
    got = pose.evaluate(opt)
    assert got["depth"]["all_errors"].shape == (SCARED_N, 7)
    np.testing.assert_allclose(got["depth"]["all_errors"], want["depth"]["all_errors"],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["depth"]["mean_temporal"], want["depth"]["mean_temporal"],
                               rtol=TEMPORAL_RTOL)
    (g,), (w,) = got["pose"], want["pose"]
    for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
        np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=k)
    for k, v in w["intrinsics_stats"].items():
        np.testing.assert_allclose(g["intrinsics_stats"][k], v, rtol=METRIC_RTOL, err_msg=k)

    got_h = hamlyn.main(["--no_cuda", *HAMLYN_EVAL, *weights])
    assert got_h["all_errors"].shape == want_h["all_errors"].shape == (HAMLYN_N, 7)
    assert np.isfinite(want_h["all_errors"]).all()
    np.testing.assert_allclose(got_h["all_errors"], want_h["all_errors"], rtol=METRIC_RTOL)


def test_scared_npy_rescore_matches_jax(both_read, tmp_path):
    """`scripts/eval_depth_video_scared_npy.sh`: saved depths (the ground
    truth with 10% noise, ``<pred_root>/<seq>/depth/{i:06d}.npy``) scored by
    both packages, frame by frame; no model is built."""
    from endodav_tpu.cli import evaluate_depth_video as jcli
    from endodav_tpu_torch.cli import evaluate_depth_video as cli
    from endodav_tpu_torch.data.readers import list_frames, read_scared_depth
    from endodav_tpu_torch.eval import engine

    gt = np.stack([read_scared_depth(p) for p in
                   list_frames(os.path.join(both_read, SEQ_VAL))["depth"]])
    noise = np.random.default_rng(9).normal(0, 0.1, gt.shape)
    pred_dir = tmp_path / "pred" / SEQ_VAL / "depth"
    os.makedirs(pred_dir)
    for i, d in enumerate(gt * (1 + noise)):
        np.save(pred_dir / f"{i:06d}.npy", d.astype(np.float32))
    args = ["--data_path", both_read, "--eval_split", "scared_video", "--pred_root",
            str(tmp_path / "pred")]
    want = jcli.evaluate(jax_opt(*args))
    built = []
    real = engine.build_depth_model
    engine.build_depth_model = lambda *a, **k: built.append(1) or real(*a, **k)
    try:
        got = cli.evaluate(port_opt(*args))
    finally:
        engine.build_depth_model = real
    assert not built
    assert got["all_errors"].shape == want["all_errors"].shape == (len(gt), 7)
    np.testing.assert_allclose(got["all_errors"], want["all_errors"], rtol=HOST_RTOL)
    np.testing.assert_allclose(got["mean_errors"], want["mean_errors"], rtol=HOST_RTOL)


def test_export_gt_depth_sh_matches_jax(both_read, trees, tmp_path, monkeypatch):
    """`scripts/export_gt_depth.sh` (``--split endovis_video --useage
    eval``, ``--what depth``) over a ``endovis_video/test_files.txt`` of the
    tree's frames (1-based, as the repo's lists), each package into its own
    copy of the split directory; the repo's ``splits/`` is not written."""
    from endodav_tpu.cli import export_gt as jexport
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu_torch.cli import export_gt

    folder = SEQ_VAL.split("/", 1)[1]
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = str(tmp_path / f"splits_{side}")
        os.makedirs(os.path.join(dirs[side], "endovis_video"))
        with open(os.path.join(dirs[side], "endovis_video", "test_files.txt"), "w") as f:
            f.write("".join(f"{folder}\t{i}\tl\n" for i in range(1, SCARED_N + 1, 3)))
    monkeypatch.setattr(jengine, "SPLITS_DIR", dirs["jax"])
    monkeypatch.setattr(jexport, "SPLITS_DIR", dirs["jax"])
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", dirs["port"])
    repo_splits = os.path.join(os.path.dirname(os.path.dirname(__file__)), "splits",
                               "endovis_video")
    before = sorted(os.listdir(repo_splits))
    args = ["--data_path", both_read, "--split", "endovis_video", "--useage", "eval"]
    _jax_main(jexport.main, [*args, "--what", "depth"])
    export_gt.main([*args, "--what", "depth"])
    got, want = (np.load(os.path.join(dirs[s], "endovis_video", "gt_depths.npz"))
                 for s in ("port", "jax"))
    assert list(got) == list(want) == ["data"]
    assert got["data"].dtype == want["data"].dtype == np.float32
    assert got["data"].shape == want["data"].shape == (4, 64, 96)
    np.testing.assert_array_equal(got["data"], want["data"])
    assert sorted(os.listdir(repo_splits)) == before
    assert not os.path.exists(os.path.join(dirs["port"], "endovis_video", "curve"))
    shutil.rmtree(tmp_path / "splits_jax")
