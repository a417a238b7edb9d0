"""`scripts/train_video_dac2.sh` on the port against the JAX package on the
CPU: its one command (its training block is commented out upstream too),
`evaluate_depth_video_pose --model_type endodac ... --visualize_depth
--pre_norm --disable_residual_block` (:10-13) on ``weights_9``.

The folder is written by the port's EndoDAC trainer built with the same
two model flags (``--pre_norm --disable_residual_block``) after one step
on a small synthetic SCARED tree (64x96 frames, T=1, the ViT input 28x42)
read through an ``endovis`` split, at epoch 9: the depth model and the pose
stack, the components the eval reads (`utils/checkpoint.save_components`,
as the trainer's `save_model`; its Adam moments and flow nets, which no
eval reads, are left out).  JAX's CLI and the port's read each their own
copy.  Tolerances as `tests/test_torch_train_loop.py`: depth errors 1e-4
relative, TAE and TAS 5%, ATE, RE and the intrinsics 1e-4.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_train_endodac import dac_read, dac_tree  # noqa: F401
from test_torch_train_loop import METRIC_RTOL, TEMPORAL_RTOL, jax_opt, port_opt

torch.set_num_threads(1)

# scripts/train_video_dac2.sh:10-13
EVAL = ["--model_type", "endodac", "--eval_split", "scared_video", "--eval_mono",
        "--visualize_depth", "--pre_norm", "--disable_residual_block"]
TRAIN = ["--model_type", "endodac", "--pre_norm", "--disable_residual_block", "--height", "64",
         "--width", "96", "--T", "1", "--batch_size", "2", "--depth_image_shape", "28", "42",
         "--num_workers", "1"]
SIZES = ["--depth_image_shape", "28", "42", "--height", "64", "--width", "96"]


def test_dac2_eval_on_the_trainers_weights_9_matches_jax(dac_read, tmp_path):  # noqa: F811
    from endodav_tpu.cli import evaluate_depth_video_pose as jcli
    from endodav_tpu_torch.cli import evaluate_depth_video_pose as cli
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import save_components

    t = Trainer(port_opt("--data_path", dac_read, "--log_dir", str(tmp_path / "log"), *TRAIN))
    model = t.mods["depth_model"]
    assert model.config["pre_norm"] and not model.config["residual_block_indexes"]
    params = dict(model.named_parameters())
    lora_b = "pretrained.blocks.0.mlp.fc1.lora_B"
    before = params[lora_b].detach().clone()
    with torch.backends.mkldnn.flags(enabled=False):
        scalars = t.train_one_batch(next(iter(t.train_loader)))
    assert np.isfinite(float(scalars["loss"])) and not torch.equal(before, params[lora_b])
    t.epoch = 9
    folder = os.path.join(t.log_path, "models", "weights_9")
    save_components(folder, {n: t.mods[n] for n in ("depth_model", "pose_encoder", "pose",
                                                    "intrinsics_head")}, metadata={
        "height": 64, "width": 96, "use_stereo": False, "dash_phase2": False})
    assert folder.endswith(os.path.join("endodac", "models", "weights_9"))

    copies = {}
    for side in ("port", "jax"):
        copies[side] = str(tmp_path / side / "weights_9")
        shutil.copytree(folder, copies[side])
    args = ["--data_path", dac_read, *EVAL, *SIZES]
    want = jcli.evaluate(jax_opt(*args, "--load_weights_folder", copies["jax"]))
    got = cli.evaluate(port_opt(*args, "--load_weights_folder", copies["port"]))
    assert got["depth"]["all_errors"].shape == (24, 7)
    np.testing.assert_allclose(got["depth"]["all_errors"], want["depth"]["all_errors"],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["depth"]["mean_temporal"], want["depth"]["mean_temporal"],
                               rtol=TEMPORAL_RTOL)
    (g,), (w,) = got["pose"], want["pose"]
    for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
        np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=k)
    for k, v in w["intrinsics_stats"].items():
        np.testing.assert_allclose(g["intrinsics_stats"][k], v, rtol=METRIC_RTOL, err_msg=k)
    shutil.rmtree(os.path.join(t.log_path, "models"))
