"""`scripts/train_video1.sh` on the port against the JAX package on the
CPU, and what each package does with its eval command.

The script trains ssb with ``--temporal_lora`` and ``--depth_reproj 1e-4``
(:10-17), then evaluates ``weights_last`` with flags that leave out both
``--lora_type ssb`` and ``--temporal_lora`` (:19-22): the eval builds the
default dvlora, whose LoRA layers hold ``lora_U`` and ``lora_V`` beside
``lora_A`` and ``lora_B``, and no temporal adapters.  Neither package can
load the folder: JAX's flax `from_bytes` and the port's `load_pytree`
both refuse a target key the file lacks, and both stop at the first
dvlora layer of the trunk (``pretrained/blocks_0/mlp/fc1``), with a
ValueError naming ``lora_U`` and ``lora_V``.  That holds for the folder
the port's trainer writes after a step of the script's training flags
and for one JAX's `save_components` writes of JAX's model at those flags.
With the two flags added, both serve the port's folder alike.

The training command is held by the two packages' parse of it (the loss
and schedule configuration) and one step of the port's trainer on a
small synthetic SCARED tree (64x96 frames, T=4, ViT input 28x42).
Tolerances as `tests/test_torch_train_loop.py`: depth errors 1e-4
relative, TAE and TAS 5%, ATE, RE and the intrinsics 1e-4.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_lora_models import KEY, _weights, tpu_route
from test_torch_train_loop import (METRIC_RTOL, TEMPORAL_RTOL, both_read, jax_opt,  # noqa: F401
                                   port_opt, tree)

torch.set_num_threads(1)

# scripts/train_video1.sh:10-17 and :19-22
TRAIN = ["--model_type", "endodav", "--num_workers", "4", "--batch_size", "1", "--T", "16",
         "--encoder", "vits", "--disable_residual_block", "--disable_conv_head",
         "--lora_type", "ssb", "--warm_up_step", "200000", "--visualize_depth",
         "--depth_reproj", "1e-4", "--temporal_lora", "--tune_spatial_interval", "400",
         "--tune_temporal_interval", "100"]
EVAL = ["--model_type", "endodav", "--eval_split", "scared_video", "--eval_mono",
        "--visualize_depth", "--disable_residual_block", "--disable_conv_head"]
MISSING = ["--lora_type", "ssb", "--temporal_lora"]
SIZES = ["--height", "64", "--width", "96", "--T", "4", "--depth_image_shape", "28", "42",
         "--num_workers", "1"]
PARSED = ("lora_type", "warm_up_step", "temporal_lora", "tune_spatial_interval",
          "tune_temporal_interval", "tune_depth_interval", "depth_reproj", "depth_flow",
          "scales", "disable_residual_block", "disable_conv_head", "visualize_depth",
          "lora_rank", "learning_rate", "batch_size", "T")


@pytest.fixture(scope="module")
def folders(tree, tmp_path_factory):
    """``weights_last`` of the port's trainer after one step at the script's
    training flags, and a folder of JAX's EndoDAV at those flags (numpy
    weights on its shapes) with JAX's `save_components`; each with the pose
    stack the eval command also reads."""
    from endodav_tpu.train.trainer import build_models
    from endodav_tpu.utils import checkpoint as jckpt
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import save_components

    mp = pytest.MonkeyPatch()
    mp.setenv("ENDODAV_TPU_SPLITS_DIR", os.path.join(tree, "splits"))
    try:
        t = Trainer(port_opt("--data_path", os.path.join(tree, "data"), "--log_dir",
                             str(tmp_path_factory.mktemp("log")), *TRAIN, *SIZES))
        with torch.backends.mkldnn.flags(enabled=False):
            scalars = t.train_one_batch(next(iter(t.train_loader)))
    finally:
        mp.undo()
    assert np.isfinite([float(scalars["loss"]), float(scalars["loss_0"])]).all()
    meta = {"height": 64, "width": 96, "use_stereo": False, "dash_phase2": False}
    stack = ("depth_model", "pose_encoder", "pose", "intrinsics_head")
    port = str(tmp_path_factory.mktemp("port") / "weights_last")
    save_components(port, {n: t.mods[n] for n in stack}, metadata=meta)

    jopt = jax_opt("--data_path", "/nonexistent", *TRAIN, *SIZES)
    depth = build_models(jopt)["depth_model"]
    variables = _weights(jax.eval_shape(depth.init, KEY, jnp.zeros((1, 4, 64, 96, 3))), seed=6)
    jfolder = str(tmp_path_factory.mktemp("jax") / "weights_last")
    jckpt.save_components(jfolder, {"depth_model": variables}, metadata=meta)
    for name in stack[1:]:
        shutil.copy(os.path.join(port, f"{name}.msgpack"), jfolder)
    return {"port": port, "jax": jfolder, "trainer": t}


def test_training_flags_parse_as_jax(folders):
    """The training command's options, and the port's trainer built from
    them: ssb with adapted motion modules, the schedule and the loss
    weights as JAX's parse gives them."""
    jopt = jax_opt("--data_path", "/nonexistent", *TRAIN)
    popt = port_opt("--data_path", "/nonexistent", *TRAIN)
    assert {k: getattr(popt, k) for k in PARSED} == {k: getattr(jopt, k) for k in PARSED}
    t = folders["trainer"]
    assert t.loss_cfg["depth_reproj"] == 1e-4 and t.sched_cfg["lora_type"] == "ssb"
    assert t.sched_cfg["warm_up_step"] == 200000 and t.sched_cfg["temporal_lora"]
    keys = t.mods["depth_model"].state_dict()
    assert any(".motion_modules." in k and k.endswith("lora_A") for k in keys)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_eval_command_refuses_the_folder_as_jax(both_read, folders, side):
    """The eval command's flags exactly, on the port's and on JAX's folder:
    both packages raise at the depth model's first dvlora layer."""
    from endodav_tpu.cli import evaluate_depth_video_pose as jcli
    from endodav_tpu_torch.cli import evaluate_depth_video_pose as cli

    args = ["--data_path", both_read, "--load_weights_folder", folders[side], *EVAL,
            "--depth_image_shape", "28", "42"]
    assert port_opt(*args).lora_type == jax_opt(*args).lora_type == "dvlora"
    with pytest.raises(ValueError) as jerr:
        jcli.evaluate(jax_opt(*args))
    with pytest.raises(ValueError) as perr:
        cli.evaluate(port_opt(*args))
    for err in (jerr, perr):
        msg = str(err.value)
        assert "lora_U" in msg and "lora_V" in msg and "pretrained/blocks_0/mlp/fc1" in msg, msg


def test_eval_with_the_missing_flags_serves_as_jax(both_read, folders, tmp_path):
    """The eval command with ``--lora_type ssb --temporal_lora`` added, on
    the port's ``weights_last`` (a copy for each package, which writes
    nothing with ``--visualize_depth`` here, as JAX's)."""
    from endodav_tpu.cli import evaluate_depth_video_pose as jcli
    from endodav_tpu_torch.cli import evaluate_depth_video_pose as cli

    copies = {}
    for side in ("port", "jax"):
        copies[side] = str(tmp_path / side)
        shutil.copytree(folders["port"], copies[side])
    args = ["--data_path", both_read, *EVAL, *MISSING, "--depth_image_shape", "28", "42",
            "--height", "64", "--width", "96"]
    with tpu_route():
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
    for side in ("port", "jax"):
        assert sorted(os.listdir(copies[side])) == sorted(os.listdir(folders["port"]))
