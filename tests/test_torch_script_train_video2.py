"""`scripts/train_video2.sh` on the port against the JAX package on the
CPU: the single-scale variant (``--scales 0``, ``--depth_reproj 1e-3
--depth_flow 1e-3``, the trainer's default dvlora, no residual blocks, no
conv head), with the script's flags exactly, the frames cut to 32x64 and
T to 2 (the ViT input 28x42).

* Both packages parse the training command into the same loss
  configuration, with one scale.
* One step's terms at one scale, on JAX's init converted into the port
  (`tests/test_torch_train_step.py`'s batch and motion): phase 0's loss
  and the gradient of every position-net parameter (against JAX in
  float64, one compile for both), and every term of `main_phase`'s loss
  dict (only ``/0``).
* The eval command, `evaluate_depth_video --visualize_depth`, on the
  ``weights_last`` depth model the port's trainer writes after a step,
  against JAX's CLI on a copy of the folder: per-frame errors and the
  saved depth files.

Tolerances as `tests/test_torch_train_step.py` (losses 1e-4 relative,
phase-0 gradients 1e-4 of their largest entry against float64, or of a
thousandth of the nets' largest gradient, whichever is larger: at one
scale some decoder parameters get gradients of 4e-8, whose f32 sums
carry 1e-12 of rounding) and
`tests/test_torch_eval_clis.py` (errors 1e-4 relative; saved depths 2e-3
relative), but a1, a2 and a3 within one pixel's share of a frame and the
saved depths 1e-3 relative inside the evaluation range (3e-4 there): after
a step the two models' disparities differ by ~1e-6, which can carry one of
6144 pixels across a threshold, and a depth is the reciprocal of the
scaled disparity (measured: one pixel at 3.6e-4, at depth 70).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_eval_clis import NPY_FAR_RTOL
from test_torch_lora_models import tpu_route
from test_torch_train_loop import METRIC_RTOL, SEQ_VAL, jax_opt, port_opt, write_tree
from test_torch_train_step import GRAD64_RTOL, LOSS_RTOL, _with_motion, make_batch

from endodav_tpu_torch.utils.convert import (COMPONENT_KIND, _INVERSE, decoder_rules,
                                              from_jax_params, resnet_encoder_rules)

torch.set_num_threads(1)

H, W = 32, 64
# scripts/train_video2.sh:9-15 and :17-20
TRAIN = ["--model_type", "endodav", "--num_workers", "4", "--batch_size", "1", "--T", "16",
         "--encoder", "vits", "--disable_residual_block", "--disable_conv_head", "--scales", "0",
         "--depth_reproj", "1e-3", "--depth_flow", "1e-3"]
EVAL = ["--model_type", "endodav", "--eval_split", "scared_video", "--eval_mono",
        "--visualize_depth", "--disable_residual_block", "--disable_conv_head"]
CUT = ["--height", str(H), "--width", str(W), "--T", "2", "--depth_image_shape", "28", "42",
       "--num_workers", "1"]
FLOOR_SHARE = 1e-3  # gradients held at least to 1e-7 of the nets' largest
NPY_RTOL = 1e-3  # measured: one pixel of 6144 at 3.6e-4, at depth 70
PIXEL_SHARE = 1.01 / (64 * 96)  # one pixel of a 64x96 frame crossing a threshold of a1-a3
CFG_KEYS = ("scales", "height", "width", "min_depth", "max_depth", "no_ssim",
            "learn_intrinsics", "transform_constraint", "transform_smoothness",
            "disparity_smoothness", "position_smoothness", "depth_reproj", "depth_flow")


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def setup(exact_cpu_convs):
    """JAX's components at the script's flags with their init (and motion),
    the port's trainer holding them, and a one-clip batch."""
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables
    from endodav_tpu_torch.train.trainer import Trainer

    jopt = jax_opt("--data_path", "/nonexistent", *TRAIN, *CUT)
    mods = build_models(jopt)
    variables = _with_motion(init_variables(mods, jopt))
    port = Trainer(port_opt("--data_path", "/nonexistent", *TRAIN, *CUT))
    for comp, kind in COMPONENT_KIND.items():
        v = jax.tree_util.tree_map(np.asarray, variables[comp])
        port.mods[comp].load_state_dict(from_jax_params(v["params"], kind, v.get("batch_stats")),
                                        strict=True)
    batch = {k: v[:1] for k, v in make_batch().items()}
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    return jopt, mods, variables, jbatch, port, port.device_batch(batch)


def test_the_script_parses_to_one_scale_as_jax(setup):
    jopt, _, _, _, port, _ = setup
    cfg = {k: port.loss_cfg[k] for k in CFG_KEYS}
    assert cfg == {k: (tuple(v) if k == "scales" else v)
                   for k, v in ((k, getattr(jopt, k)) for k in CFG_KEYS)}
    assert cfg["scales"] == (0,) and cfg["depth_reproj"] == cfg["depth_flow"] == 1e-3
    assert port.opt.lora_type == jopt.lora_type == "dvlora"
    assert not port.mods["depth_model"].config["residual_block_indexes"]


def test_one_scale_phase0_loss_and_grads_match_jax(setup):
    from flax.traverse_util import flatten_dict

    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.train import losses as TL
    from endodav_tpu_torch.train import optim as TO

    _, mods, variables, jbatch, port, tbatch = setup
    scales = port.loss_cfg["scales"]

    def loss0_of(mods_, variables_, batch_):
        def loss0(pp):
            v = dict(variables_)
            v["position_encoder"] = {"params": pp["position_encoder"],
                                     "batch_stats": variables_["position_encoder"]["batch_stats"]}
            v["position"] = {"params": pp["position"]}
            out, _ = JL.forward_flow_nets(mods_, v, batch_, scales, (H, W), True, False)
            return JL.position_phase_loss(out, batch_, scales, 1e-3, True)
        return loss0

    pp = {k: variables[k]["params"] for k in ("position_encoder", "position")}
    with jax.enable_x64(True):  # one compile gives the loss and its gradient
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        mods64 = dict(mods, position_encoder=mods["position_encoder"].clone(dtype=jnp.float64),
                      position=mods["position"].clone(dtype=jnp.float64))
        jl, jg = jax.jit(jax.value_and_grad(loss0_of(mods64, f64(variables), f64(jbatch))))(
            f64(pp))
        jl, jg = float(jl), jax.tree_util.tree_map(np.asarray, jg)

    TO.set_trainable(port.main_mods, None)
    TO.set_trainable(port.pos_mods, port.all_pos)
    out = TL.forward_flow_nets(port.mods, tbatch, scales, (H, W), True, False)
    assert {k[1] for k in out if k[0] == "position" and isinstance(k[1], int)} == {0}
    tl = TL.position_phase_loss(out, tbatch, scales, 1e-3, True)
    port.opt_pos.zero_grad()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    floor = FLOOR_SHARE * max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(jg))
    for comp, rules in (("position_encoder", resnet_encoder_rules()),
                        ("position", decoder_rules())):
        flat = flatten_dict(jg[comp])
        rule = {t: (f, layout) for t, f, layout in rules}
        for name, prm in port.mods[comp].named_parameters():
            f, layout = rule[name]
            if prm.grad is None:  # a scale the script does not train
                assert not np.any(flat[f]), name
                continue
            want = _INVERSE[layout](flat[f])
            err = float(np.abs(prm.grad.numpy() - want).max())
            assert err <= GRAD64_RTOL * max(float(np.abs(want).max()), floor), (name, err)
    TO.set_trainable(port.pos_mods, None)
    for m in port.mods["position_encoder"].modules():
        if hasattr(m, "pending"):
            m.pending = None


def test_one_scale_main_phase_losses_match_jax(setup):
    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.train import losses as TL

    _, mods, variables, jbatch, port, tbatch = setup
    cfg = dict(port.loss_cfg)
    jlosses = jax.jit(lambda v: JL.main_phase(mods, v, jbatch, cfg)[1]["losses"])(variables)
    with torch.no_grad():
        _, aux = TL.main_phase(port.mods, tbatch, cfg)
    assert set(aux["losses"]) == set(jlosses)
    assert not any(k.endswith(("/1", "/2", "/3")) for k in jlosses)
    assert "loss/loss_depth_flow/0" in jlosses
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for m in port.mods.values():
        for bn in m.modules():
            if hasattr(bn, "pending"):
                bn.pending = None


def test_eval_command_on_weights_last_matches_jax(setup, tmp_path, monkeypatch):
    """A step of the port's trainer on the tree, its depth model written
    as ``weights_last`` (the component the eval reads, with the trainer's
    metadata), then the script's eval command in each package on its own
    copy (each writes ``eval/scared_video/<seq>/depth/*.npy`` into it)."""
    from endodav_tpu import native
    from endodav_tpu.cli import evaluate_depth_video as jcli
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.train import trainer as jtrainer
    from endodav_tpu_torch.cli import evaluate_depth_video as cli
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import save_components

    root = write_tree(str(tmp_path / "tree"))
    splits = os.path.join(root, "splits")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jengine, "SPLITS_DIR", splits)
    monkeypatch.setattr(jtrainer, "SPLITS_DIR", splits)
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", splits)
    data = os.path.join(root, "data")
    sizes = ["--height", "64", "--width", "96", "--T", "4", "--depth_image_shape", "28", "42",
             "--num_workers", "1"]
    t = Trainer(port_opt("--data_path", data, "--log_dir", str(tmp_path / "log"), *TRAIN,
                         *sizes))
    assert t.train_one_batch(next(iter(t.train_loader)))["loss"].isfinite()
    folders = {side: str(tmp_path / side / "weights_last") for side in ("port", "jax")}
    save_components(folders["port"], {"depth_model": t.mods["depth_model"]}, metadata={
        "height": 64, "width": 96, "use_stereo": False, "dash_phase2": False})
    shutil.copytree(folders["port"], folders["jax"])
    args = ["--data_path", data, *EVAL, "--depth_image_shape", "28", "42"]
    with tpu_route():
        want = jcli.evaluate(jax_opt(*args, "--load_weights_folder", folders["jax"]))
    got = cli.evaluate(port_opt(*args, "--load_weights_folder", folders["port"]))
    assert got["all_errors"].shape == want["all_errors"].shape == (24, 7)
    np.testing.assert_allclose(got["all_errors"][:, :4], want["all_errors"][:, :4],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["all_errors"][:, 4:], want["all_errors"][:, 4:], rtol=0,
                               atol=PIXEL_SHARE)
    dirs = [os.path.join(folders[s], "eval", "scared_video", SEQ_VAL, "depth")
            for s in ("port", "jax")]
    names = [sorted(os.listdir(d)) for d in dirs]
    assert names[0] == names[1] == [f"{i:06d}.npy" for i in range(24)]
    for name in names[0]:
        g, w = (np.load(os.path.join(d, name)) for d in dirs)
        assert g.shape == w.shape == (64, 96)
        np.testing.assert_allclose(np.clip(g, 1e-3, 150), np.clip(w, 1e-3, 150), rtol=NPY_RTOL)
        np.testing.assert_allclose(g, w, rtol=NPY_FAR_RTOL)
