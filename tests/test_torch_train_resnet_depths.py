"""The port's trainer at ``--num_layers`` 50, 101 and 152, in f32 and in
``--compute_dtype bfloat16``, on the CPU at the tiny configuration of
`tests/test_torch_train_step.py` at one clip (32x64 frames, B=1, T=2, ViT
input 28x42): it builds the three bottleneck encoders and the decoders on
their 2048-channel top maps and takes a step (finite losses; the position,
pose and transform encoders move, their BatchNorm statistics are
committed); the f32 trainer's pose stack, written with
`utils/checkpoint.save_components`, loads bit for bit into the bf16
trainer of the same depth, which steps too.  At ResNet-50 the checkpoint
goes both ways with the JAX package: JAX's `load_components` reads the
port's folder leaf for leaf, and the port's trainer reads a folder JAX's
`save_components` wrote.  The folders hold ResNet components only (the
depth model's checkpoints are `tests/test_torch_checkpoint.py`'s), and are
deleted at once: three ResNet-152 encoders with Adam's moments would take
2.8 GB.
"""

import shutil

import numpy as np
import pytest
import torch

import jax

from test_torch_endodac import _fan_in
from test_torch_train_step import FLAGS, _jax_opt, make_batch

torch.set_num_threads(1)

ENCODERS = ("position_encoder", "transform_encoder", "pose_encoder")
RESNET_COMPONENTS = ("position_encoder", "position", "pose_encoder", "pose")


def _trainer(*extra):
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    return Trainer(EndoDAVOptions().parse([*FLAGS, *extra, "--batch_size", "1"]))


def _step_moves_the_encoders(t):
    """One step: finite losses; each encoder's last conv moved and its
    BatchNorm statistics committed."""
    before = {n: {k: v.clone() for k, v in t.mods[n].state_dict().items()} for n in ENCODERS}
    scalars = t.train_one_batch({k: v[:1] for k, v in make_batch().items()})
    assert np.isfinite([float(scalars["loss"]), float(scalars["loss_0"])]).all()
    for name in ENCODERS:
        after = t.mods[name].state_dict()
        moved = {k for k in after if not torch.equal(before[name][k], after[k])}
        assert f"encoder.layer4.{len(t.mods[name].encoder.layer4) - 1}.conv3.weight" in moved
        assert "encoder.layer4.0.bn3.running_var" in moved, name  # committed


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_trainer_builds_steps_saves_and_reloads(depth, tmp_path):
    """At each depth: an f32 trainer steps and writes its pose stack; a
    ``--compute_dtype bfloat16`` trainer loads it bit for bit
    (``--load_weights_folder --models_to_load``; parameters stay f32 in
    either dtype) and steps in bf16."""
    from endodav_tpu_torch.utils.checkpoint import save_components

    stack = ("pose_encoder", "pose")
    t = _trainer("--num_layers", str(depth))
    for name in ENCODERS:
        assert t.mods[name].encoder.layer4[-1].conv3.out_channels == 2048
    assert t.mods["pose"].convs["squeeze"].in_channels == 2048
    _step_moves_the_encoders(t)
    folder = str(tmp_path / "weights")
    save_components(folder, {n: t.mods[n] for n in stack})
    try:
        t16 = _trainer("--num_layers", str(depth), "--compute_dtype", "bfloat16",
                       "--load_weights_folder", folder, "--models_to_load", *stack)
    finally:
        shutil.rmtree(folder)
    for name in stack:
        a, b = t.mods[name].state_dict(), t16.mods[name].state_dict()
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), name
    del t
    assert t16.mods["pose_encoder"].dtype == torch.bfloat16
    _step_moves_the_encoders(t16)


def _jax_shapes():
    from endodav_tpu.train.trainer import build_models, init_variables

    jopt = _jax_opt()
    jopt.num_layers = 50
    mods = build_models(jopt)
    return jax.eval_shape(lambda: init_variables(mods, jopt))


def test_resnet50_checkpoints_both_ways(tmp_path):
    """The port's ResNet-50 components written by its `save_components`
    and read by JAX's `load_components` (on JAX's variable shapes), every
    leaf equal to the port's tensor in JAX's layout; a folder JAX's
    `save_components` wrote (numpy weights on those shapes) read by the
    port's trainer (``--load_weights_folder --models_to_load``), every
    tensor equal to `from_jax_params` of JAX's leaves."""
    from endodav_tpu.utils import checkpoint as jckpt
    from endodav_tpu_torch.utils.checkpoint import component_kind
    from endodav_tpu_torch.utils.convert import from_jax_params, to_jax_params

    from endodav_tpu_torch.utils.checkpoint import save_components

    shapes = _jax_shapes()
    t = _trainer("--num_layers", "50")
    folder = str(tmp_path / "port")
    save_components(folder, {n: t.mods[n] for n in RESNET_COMPONENTS})
    try:
        loaded = jckpt.load_components(folder, {n: shapes[n] for n in RESNET_COMPONENTS})
    finally:
        shutil.rmtree(folder)
    leaves = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)  # noqa: E731
                           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    for name in RESNET_COMPONENTS:
        want = leaves(to_jax_params(t.mods[name].state_dict(),
                                    component_kind(name, t.mods[name])))
        got = leaves(loaded[name])
        assert set(got) == set(want), name
        assert all(np.array_equal(got[k], v) for k, v in want.items()), name

    variables = {name: _fan_in(shapes[name], seed=i) for i, name in enumerate(RESNET_COMPONENTS)}
    jfolder = str(tmp_path / "jax")
    jckpt.save_components(jfolder, variables)
    try:
        port = _trainer("--num_layers", "50", "--load_weights_folder", jfolder,
                        "--models_to_load", *RESNET_COMPONENTS)
    finally:
        shutil.rmtree(jfolder)
    for name in RESNET_COMPONENTS:
        v = variables[name]
        want = from_jax_params(v["params"], component_kind(name, port.mods[name]),
                               v.get("batch_stats"))
        got = port.mods[name].state_dict()
        assert set(got) == set(want), name
        assert all(torch.equal(got[k], want[k]) for k in want), name
