"""Training with the single-frame depth models, EndoDAC and AF-SfM, on the
port against the JAX package on the CPU.

At the tiny configuration of `tests/test_torch_train_step.py` (32x64
frames, B=2, T=2, ViT input 28x42; JAX's init converted into the port by
`utils/checkpoint.load_variables`), for EndoDAC vits and vitb with dvlora,
EndoDAC vits with a BatchNorm head (``use_bn``) and AF-SfM:

* every term of `main_phase`'s loss dict (the clip flattened to its
  frames, as JAX's models do);
* the depth model's BatchNorm statistics are not committed (JAX's
  `main_phase` drops them);
* the schedule groups leaf by leaf as JAX's `assign_groups` labels them
  (every AF-SfM depth parameter ``frozen``);
* one whole step (`slow`: JAX's step jit), whose updates move the LoRA B
  and the conv_depth head of EndoDAC and leave its frozen ViT weight, and
  every AF-SfM depth weight and statistic, where they were.

On a small synthetic SCARED tree (`test_torch_train_loop.write_tree`, with
an ``endovis`` split beside ``scared_video``): the ``--T -1`` raise and the
split choice, as JAX's `_setup_data`; the epoch eval with EndoDAC through
the window path against JAX's, and AF-SfM's raise at the same point as
JAX's; EndoDAC checkpoints both ways (JAX's `load_components` on the port's
``weights_last``, the port on JAX's folder) and
`cli/evaluate_depth_video_pose --model_type endodac` on them against JAX's
CLI.

Tolerances as `tests/test_torch_train_step.py` and
`tests/test_torch_train_loop.py`: losses relative 1e-4; one-step updates
within 1e-3 of their largest entry; depth metrics relative 1e-4, TAE and
TAS 5%.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_loop import (METRIC_RTOL, SEQ_TRAIN, SEQ_VAL, TEMPORAL_RTOL, jax_opt,
                                   port_opt, random_variables, write_tree)
from test_torch_train_step import (FLAGS, LOSS_RTOL, _assert_close_rel, _jax_opt, _loss_cfg,
                                   _with_motion, make_batch)

torch.set_num_threads(1)

CONFIGS = {  # model type, encoder, EndoDAC's use_bn, --disable_conv_head
    "endodac_vits": ("endodac", "vits", False, True),  # train_video_dac1.sh's head
    "endodac_vitb": ("endodac", "vitb", False, False),
    "endodac_vits_bn": ("endodac", "vits", True, True),
    "afsfm": ("afsfm", "vits", False, False),
}
_JAX_INIT = {}  # JAX's init trees by (model type, encoder, --disable_conv_head)
COMPONENTS = ("depth_model", "position_encoder", "position", "transform_encoder", "transform",
              "pose_encoder", "pose", "intrinsics_head")
# the tree's model flags: EndoDAC vits, dvlora, train_video_dac1.sh's head
DAC_ARGS = ["--model_type", "endodac", "--height", "64", "--width", "96", "--T", "1",
            "--batch_size", "2", "--depth_image_shape", "28", "42", "--disable_conv_head",
            "--residual_block_indexes", "1", "--num_workers", "1"]


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _jax_init(jopt):
    """JAX's components and init variables at ``jopt``, each tree computed
    once a module."""
    from endodav_tpu.train.trainer import build_models, init_variables

    mods = build_models(jopt)
    key = (jopt.model_type, jopt.encoder, jopt.disable_conv_head)
    if key not in _JAX_INIT:
        _JAX_INIT[key] = jax.tree_util.tree_map(np.asarray, init_variables(mods, jopt))
    return mods, _JAX_INIT[key]


def _port_trainer(model_type, encoder, variables, use_bn=False, head=()):
    """The port's Trainer on the CPU with JAX's variables loaded; with
    ``use_bn`` its depth model replaced by the same EndoDAC with a
    BatchNorm head (which no flag builds)."""
    from endodav_tpu_torch.models.endodac import EndoDAC
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import load_variables

    t = Trainer(EndoDAVOptions().parse([*FLAGS, "--model_type", model_type, "--encoder",
                                        encoder, *head]))
    if use_bn:
        t.mods["depth_model"] = EndoDAC(**{**t.mods["depth_model"].config, "use_bn": True})
    for comp, module in t.mods.items():
        load_variables(comp, module, jax.tree_util.tree_map(np.asarray, variables[comp]))
    return t


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request, exact_cpu_convs):
    """JAX's components and variables (with motion) for one configuration,
    and the port's trainer holding the same weights; with ``use_bn`` the
    depth model on both sides is EndoDAC with a BatchNorm head."""
    model_type, encoder, use_bn, no_head = CONFIGS[request.param]
    jopt = _jax_opt()
    jopt.model_type, jopt.encoder, jopt.disable_conv_head = model_type, encoder, no_head
    mods, variables = _jax_init(jopt)
    variables = dict(variables)
    if use_bn:
        mods["depth_model"] = mods["depth_model"].clone(use_bn=True)
        init = jax.jit(lambda k: mods["depth_model"].init(k, jnp.zeros((1, 32, 64, 3))))
        variables["depth_model"] = random_variables(
            jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3))), seed=3)
    variables = _with_motion(variables)
    head = ["--disable_conv_head"] if no_head else []
    return request.param, mods, variables, _port_trainer(model_type, encoder, variables, use_bn,
                                                         head)


def _depth_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running_" in k}


def test_main_phase_losses_match_jax(setup):
    """Every term of `main_phase` against JAX's at f32; the depth model's
    BatchNorm statistics neither committed nor left pending, and absent
    from JAX's new statistics."""
    from endodav_tpu.train import losses as JL
    from endodav_tpu.train.trainer import _flatten_bt

    from endodav_tpu_torch.models.resnet import BatchNorm
    from endodav_tpu_torch.train import losses as TL

    name, mods, variables, port = setup
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    cfg = _loss_cfg()
    jlosses, jstats = jax.jit(
        lambda v: (lambda aux: (aux["losses"], aux["batch_stats"]))(
            JL.main_phase(mods, v, jbatch, cfg)[1]))(variables)
    depth = port.mods["depth_model"]
    before = _depth_stats(depth)
    with torch.no_grad():
        _, aux = TL.main_phase(port.mods, port.device_batch(batch), cfg)
    assert set(aux["losses"]) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert set(jstats) == {"transform_encoder", "pose_encoder"}
    assert (len(before) > 0) == (name in ("afsfm", "endodac_vits_bn"))
    after = _depth_stats(depth)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(m.pending is None for m in depth.modules() if isinstance(m, BatchNorm))
    for comp in ("transform_encoder", "pose_encoder"):  # drop what the encoders recorded
        for m in port.mods[comp].modules():
            if isinstance(m, BatchNorm):
                m.pending = None


def test_groups_match_jax(setup):
    """`assign_groups` leaf by leaf as JAX's on the main components (the
    BatchNorm head's scales and biases too); every AF-SfM depth parameter
    in ``frozen``."""
    from flax.traverse_util import flatten_dict

    from endodav_tpu.train import optim as JO
    from endodav_tpu_torch.train import optim as TO
    from endodav_tpu_torch.train.trainer import MAIN_COMPONENTS
    from endodav_tpu_torch.utils.checkpoint import component_kind
    from endodav_tpu_torch.utils.convert import jax_paths

    name, _, variables, port = setup
    want = JO.assign_groups({k: variables[k]["params"] for k in MAIN_COMPONENTS})
    got = TO.assign_groups({k: port.mods[k] for k in MAIN_COMPONENTS})
    if name != "endodac_vits_bn":
        assert got == port.groups
    for comp in MAIN_COMPONENTS:
        flat = flatten_dict(want[comp])
        paths = jax_paths(component_kind(comp, port.mods[comp]))
        labels = {n: flat[paths[n][1][1:]] for n in got[comp]}
        assert labels == got[comp], comp
        assert len(got[comp]) == len(flat)
    if name == "afsfm":
        assert set(got["depth_model"].values()) == {"frozen"}


def _one_step(tmp_path, model_type, encoder, checks):
    """One whole step of JAX's trainer and the port's on the same variables
    and batch: both losses, and the update of each (port name, JAX path)
    of the depth model in ``checks`` -- within 1e-3 of its largest entry
    where the gradient is above 0.1 of its largest, or zero on both sides
    where the port's optimizer holds no state for it."""
    from flax.traverse_util import flatten_dict

    from endodav_tpu.train.trainer import Trainer as JTrainer
    from endodav_tpu_torch.utils.checkpoint import component_kind
    from endodav_tpu_torch.utils.convert import jax_paths

    jopt = _jax_opt()
    jopt.log_dir = str(tmp_path)
    jopt.model_type, jopt.encoder = model_type, encoder
    jt = JTrainer(jopt)
    jt.variables = _with_motion(jt.variables)
    port = _port_trainer(model_type, encoder, jt.variables)
    init = jax.tree_util.tree_map(np.array, jt.variables)
    batch = make_batch()
    jsc = jt.train_one_batch(batch)
    tsc = port.train_one_batch(batch)
    np.testing.assert_allclose(float(tsc["loss"]), float(jsc["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tsc["loss_0"]), float(jsc["loss_0"]), rtol=LOSS_RTOL)
    depth = port.mods["depth_model"]
    paths = jax_paths(component_kind("depth_model", depth))
    state = dict(depth.state_dict())
    for n in checks:
        col, path = paths[n]
        before = np.asarray(flatten_dict(init["depth_model"])[path])
        want = np.asarray(flatten_dict(jt.variables["depth_model"])[path]) - before
        got = to_layout(state[n], col) - before
        prm = dict(depth.named_parameters()).get(n)
        st = port.opt_main.state_of(prm) if prm is not None else {}
        if not st:
            assert not want.any() and not got.any(), n
            continue
        m = np.abs(to_layout(st["exp_avg"], col))
        sure = m > 0.1 * m.max()
        assert want[sure].any(), n
        _assert_close_rel(got[sure], want[sure], 1e-3)
    return port


def to_layout(t, layout):
    """A port tensor in JAX's layout (`utils/convert.py`)."""
    from endodav_tpu_torch.utils import convert

    return np.asarray(convert._FORWARD[layout](t.detach().float().numpy()))


@pytest.mark.slow
def test_endodac_step_matches_jax(tmp_path):
    """EndoDAC vits dvlora: fc1's LoRA B (A's gradient is zero at the zero B
    of the init) and the conv_depth head move as JAX's; a frozen ViT weight
    moves on neither side."""
    _one_step(tmp_path, "endodac", "vits", [
        "pretrained.blocks.0.mlp.fc1.lora_B", "depth_head.conv_depth_1.head.0.weight",
        "pretrained.blocks.0.mlp.fc1.weight"])


@pytest.mark.slow
def test_afsfm_step_matches_jax(tmp_path):
    """AF-SfM: its depth weights and running statistics move on neither side
    (all ``frozen``); the losses as JAX's."""
    port = _one_step(tmp_path, "afsfm", "vits", [
        "encoder.encoder.conv1.weight", "depth.convs.dispconv_0.conv.weight",
        "encoder.encoder.bn1.running_mean", "encoder.encoder.layer1.0.bn1.running_var"])
    assert not any(p.grad is not None for p in port.mods["depth_model"].parameters())


# ------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def dac_tree(tmp_path_factory):
    """`write_tree`'s two sequences with an ``endovis`` split whose train
    list holds both (``scared_video``'s holds one)."""
    root = write_tree(str(tmp_path_factory.mktemp("scared_dac")))
    split = os.path.join(root, "splits", "endovis")
    os.makedirs(split)
    for name, seqs in (("train", (SEQ_TRAIN, SEQ_VAL)), ("val", (SEQ_VAL,))):
        with open(os.path.join(split, f"{name}_files.txt"), "w") as f:
            f.write("\n".join(seqs) + "\n")
    return root


@pytest.fixture
def dac_read(dac_tree, monkeypatch):
    """Both packages on the tree's split directory, JAX through PIL."""
    from endodav_tpu import native
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.train import trainer as jtrainer

    splits = os.path.join(dac_tree, "splits")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jengine, "SPLITS_DIR", splits)
    monkeypatch.setattr(jtrainer, "SPLITS_DIR", splits)
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", splits)
    return os.path.join(dac_tree, "data")


def _jax_setup_data(opt):
    from endodav_tpu.train.trainer import Trainer as JTrainer

    stand_in = types.SimpleNamespace(opt=opt)
    JTrainer._setup_data(stand_in)
    return stand_in


@pytest.mark.parametrize("model_type", ["endodac", "afsfm", "endodav"])
def test_setup_data_reads_the_split_of_the_model(dac_read, model_type, monkeypatch):
    """The train and val clips from ``endovis`` for a single-frame model and
    from ``scared_video`` for EndoDAV, the epoch eval's sequences from
    ``scared_video``: the same files and clip counts as JAX's."""
    from endodav_tpu_torch.train import trainer as T

    monkeypatch.setattr(T, "init_train_", lambda mods, seed: mods)  # the weights play no part
    args = ["--data_path", dac_read, *DAC_ARGS[2:], "--model_type", model_type]
    want = _jax_setup_data(jax_opt(*args))
    got = T.Trainer(port_opt(*args))
    frames = got.train_dataset.frames
    assert frames == want.train_dataset.paths["left"]
    assert got.val_loader.dataset.frames == want.val_loader.dataset.paths["left"]
    assert len(got.train_dataset) == len(want.train_dataset) > 0
    assert got.test_sequences.filenames == want.test_sequences.filenames == [SEQ_VAL]
    assert len({os.path.dirname(os.path.dirname(f)) for f in frames}) == (
        2 if model_type != "endodav" else 1)


def test_T_minus_one_raises_as_jax(dac_read, monkeypatch):
    """``--T -1`` (`scripts/train_video_dac.sh`, `scripts/train.sh`) yields no
    clips; the port raises JAX's error, word for word."""
    from endodav_tpu_torch.train import trainer as T

    monkeypatch.setattr(T, "init_train_", lambda mods, seed: mods)
    args = ["--data_path", dac_read, "--model_type", "endodac", "--encoder", "vitb",
            "--batch_size", "8", "--T", "-1", "--lora_type", "dvlora", "--split", "endovis",
            "--depth_image_shape", "28", "42"]
    with pytest.raises(ValueError) as want:
        _jax_setup_data(jax_opt(*args))
    with pytest.raises(ValueError) as got:
        T.Trainer(port_opt(*args))
    assert str(got.value) == str(want.value)
    assert "the default -1 yields no clips" in str(got.value)


@pytest.fixture(scope="module")
def jax_dac(tmp_path_factory):
    """JAX's eight components at `DAC_ARGS` with seeded variables (the
    trees of `_jax_init`; no parameter's shape depends on the frame size),
    and the folder JAX's `save_components` writes of them."""
    from endodav_tpu.utils import checkpoint as jckpt

    mods, init = _jax_init(jax_opt("--data_path", "/nonexistent", *DAC_ARGS))
    variables = {k: random_variables(init[k], seed=i) for i, k in enumerate(COMPONENTS)}
    folder = str(tmp_path_factory.mktemp("jax_dac_weights"))
    jckpt.save_components(folder, variables, metadata={
        "height": 64, "width": 96, "use_stereo": False, "dash_phase2": False})
    return mods, variables, folder


def test_epoch_eval_single_frame_matches_jax(dac_read, jax_dac, tmp_path, monkeypatch):
    """`Trainer.run_epoch_eval` with EndoDAC through the window path against
    JAX's (``model.apply(variables, win)``, JAX :607) on a stand-in of its
    trainer: depth metrics within 1e-4, TAE and TAS within 5%, ATE and RE
    within 1e-4.  Where JAX's call fails, the port's fails at the same point
    with the same AttributeError: EndoDAC with the dedup pipeline (no
    ``encoder`` for its rule), AF-SfM (no ``image_shape`` for the dedup
    decision, JAX :614)."""
    from endodav_tpu.data.scared import ScaredVideos as JVideos
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.eval import metrics as JM
    from endodav_tpu.train.trainer import Trainer as JTrainer
    from endodav_tpu.train.trainer import build_models
    from endodav_tpu_torch.train.trainer import Trainer
    from test_torch_train_loop import _recording

    mods, variables, folder = jax_dac
    errors, pose = [], []
    _recording(monkeypatch, JM, "compute_errors", errors)
    _recording(monkeypatch, jengine, "evaluate_pose_pairs", pose)
    opt = jax_opt("--data_path", dac_read, *DAC_ARGS)
    stand_in = types.SimpleNamespace(opt=opt, mods=mods, variables=variables, writers={},
                                     test_sequences=JVideos(dac_read, [SEQ_VAL]),
                                     log_path=str(tmp_path / "jax"), epoch=1)
    JTrainer.run_epoch_eval(stand_in)
    t = Trainer(port_opt("--data_path", dac_read, "--log_dir", str(tmp_path / "port"),
                         "--load_weights_folder", folder, "--models_to_load", *COMPONENTS,
                         *DAC_ARGS))
    t.epoch = 1
    rmse, a1 = t.run_epoch_eval()
    want_depth = np.array([e for e in errors if not np.isnan(e).all()]).mean(0)
    np.testing.assert_allclose(t.eval_results["values"][:7], want_depth, rtol=METRIC_RTOL)
    np.testing.assert_allclose((rmse, a1), want_depth[[2, 4]], rtol=METRIC_RTOL)
    assert np.isfinite(t.eval_results["values"][7:]).all()
    for k in ("ate_mean", "re_mean"):
        np.testing.assert_allclose(t.eval_results["pose"][0][k], pose[0][k], rtol=METRIC_RTOL)

    # with the dedup pipeline (ENDODAV_DEDUP=1; on by default from 512 patch
    # tokens) EndoDAC has no ``encoder`` for its rule, in both packages
    monkeypatch.setenv("ENDODAV_DEDUP", "1")
    stand_in = types.SimpleNamespace(opt=opt, mods=mods, variables=variables, writers={},
                                     test_sequences=JVideos(dac_read, [SEQ_VAL]),
                                     log_path=str(tmp_path / "jax_dedup"), epoch=1)
    with pytest.raises(AttributeError, match="encoder"):
        JTrainer.run_epoch_eval(stand_in)
    del t._eval_forward
    with pytest.raises(AttributeError, match="encoder"):
        t.run_epoch_eval()
    monkeypatch.delenv("ENDODAV_DEDUP")

    af = [*DAC_ARGS, "--model_type", "afsfm"]
    jaf = jax_opt("--data_path", dac_read, *af)
    stand_in = types.SimpleNamespace(opt=jaf, mods=build_models(jaf), variables=None,
                                     writers={}, test_sequences=JVideos(dac_read, [SEQ_VAL]),
                                     log_path=str(tmp_path / "jax_af"), epoch=1)
    with pytest.raises(AttributeError, match="image_shape"):
        JTrainer.run_epoch_eval(stand_in)
    t = Trainer(port_opt("--data_path", dac_read, "--log_dir", str(tmp_path / "port_af"), *af))
    with pytest.raises(AttributeError, match="image_shape"):
        t.run_epoch_eval()


def test_endodac_checkpoints_both_ways_and_served(dac_read, jax_dac, tmp_path):
    """The port's Trainer loads JAX's EndoDAC folder bit for bit and writes
    ``weights_last``, which JAX's `load_components` reads back to JAX's
    arrays; `cli/evaluate_depth_video_pose --model_type endodac` on the
    port's folder against JAX's CLI on JAX's: per-frame depth errors within
    1e-4, TAE and TAS within 5%, ATE, RE and intrinsics within 1e-4."""
    from flax.traverse_util import flatten_dict

    from endodav_tpu.cli import evaluate_depth_video_pose as jcli
    from endodav_tpu.utils import checkpoint as jckpt
    from endodav_tpu_torch.cli import evaluate_depth_video_pose as cli
    from endodav_tpu_torch.train.trainer import Trainer

    _, variables, folder = jax_dac
    t = Trainer(port_opt("--data_path", "/nonexistent", "--log_dir", str(tmp_path),
                         "--load_weights_folder", folder, "--models_to_load", *COMPONENTS,
                         *DAC_ARGS))
    t.epoch = 1
    ours = t.save_model(mode="last")
    assert ours.endswith(os.path.join("endodac", "models", "weights_last"))
    back = jckpt.load_components(ours, jax.tree_util.tree_map(np.zeros_like, variables),
                                 list(COMPONENTS))
    for comp in COMPONENTS:
        want, got = flatten_dict(variables[comp]), flatten_dict(back[comp])
        assert set(got) == set(want), comp
        assert all(np.array_equal(np.asarray(got[k]), np.asarray(want[k])) for k in want), comp

    args = ["--data_path", dac_read, "--model_type", "endodac", "--eval_mono",
            "--eval_split", "scared_video", "--visualize_depth", *DAC_ARGS[2:]]
    want = jcli.evaluate(jax_opt(*args, "--load_weights_folder", folder))
    got = cli.evaluate(port_opt(*args, "--load_weights_folder", ours))
    np.testing.assert_allclose(got["depth"]["all_errors"], want["depth"]["all_errors"],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["depth"]["mean_temporal"], want["depth"]["mean_temporal"],
                               rtol=TEMPORAL_RTOL)
    (g,), (w,) = got["pose"], want["pose"]
    for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
        np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=k)
    for k, v in w["intrinsics_stats"].items():
        np.testing.assert_allclose(g["intrinsics_stats"][k], v, rtol=METRIC_RTOL, err_msg=k)


def test_visualize_depth_flag(dac_read, tmp_path):
    """``--visualize_depth`` (`scripts/train_video_dac1.sh`) parses for the
    trainer and `evaluate_depth_video_pose`, which write no images with it,
    as JAX's; `evaluate_depth_video`, whose JAX counterpart writes depth
    images under the weights folder, refuses it there (not ported)."""
    from endodav_tpu_torch.cli import evaluate_depth_video

    opt = port_opt("--data_path", dac_read, "--visualize_depth", *DAC_ARGS)
    assert opt.visualize_depth and jax_opt("--visualize_depth").visualize_depth
    with pytest.raises(NotImplementedError, match="visualize_depth"):
        evaluate_depth_video.evaluate(port_opt("--data_path", dac_read, "--visualize_depth",
                                               "--load_weights_folder", str(tmp_path)))
