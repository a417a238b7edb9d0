"""Port parity of whole models with the LoRA family on the CPU against the
JAX package: the full-width vits EndoDAV (12 blocks, a small image) with
ssb and ``--temporal_lora`` (the flags of `scripts/eval_depth_video1.sh`
otherwise) and with Dash in each phase, EndoDAC with ssb (disparities
within 1e-5 of max(1, their largest entry), ViT taps within 1e-4, as
`tests/test_torch_endodac.py`, whose sigmoid disparities stay below 1); ssb
at bf16 against JAX at JAX's init weights (2.5e-2 max, 4e-3 mean, the
output dtype checked); ``evaluate_depth_video --lora_type ssb`` on a
synthetic SCARED tree against JAX's CLI with the same weights (JAX params
-> `from_jax_params` -> a ``depth_model.pth`` both load), as built and with
``--merge_lora``; and Dash's phase boundary in the trainer against JAX's
`_maybe_dash_phase_boundary`.

The JAX models run their TPU serving route, the fused temporal block in
Pallas's interpreter, as the port serves (its LayerNorm eps 1e-5).
Weights come from numpy seeds: fan-in scaled kernels, ssb's scale vectors
near 1 (a fan-in scale would shrink the whole trunk), Dash's index and
singular directions nonzero."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.models.endodac import EndoDAC
from endodav_tpu_torch.models.endodav import EndoDAV
from endodav_tpu_torch.models.lora import set_dash_phase2
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TOL = 1e-5      # disparities at f32
TAP_TOL = 1e-4  # ViT taps at f32
METRIC_RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
# the shipped eval's model flags (scripts/eval_depth_video1.sh)
SHIPPED = dict(lora_type="ssb", residual_block_indexes=(), conv_head=False)


def _weights(shapes, seed):
    """Numpy weights for a JAX variable tree of shapes: fan-in scaled
    kernels, small biases and Dash indices, norm scales and ssb's [n, 1]
    scale vectors near 1; a LoRA B at a tenth of the fan-in scale, so that
    the adapters' delta is a fifth of the frozen weight's, not its equal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        ssb = name.endswith(("'lora_A']", "'lora_B']")) and s.shape[-1] == 1
        if len(s.shape) > 1 and not ssb:
            scale = 0.1 if name.endswith("'lora_B']") else 1.0
            return (scale * rng.standard_normal(s.shape)
                    * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        base = 1.0 if ssb or "'scale'" in name or "gamma" in name else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def tpu_route():
    """JAX's motion modules on the fused (TPU) block, every `pl.pallas_call`
    on Pallas's generic interpreter."""
    from endodav_tpu.models import motion as jmotion

    real_call, real_fused = pl.pallas_call, jmotion._use_fused_block
    pl.pallas_call = lambda *a, **k: real_call(*a, **{**k, "interpret": True})
    jmotion._use_fused_block = lambda pos, dim: pos == "ape"
    try:
        yield
    finally:
        pl.pallas_call, jmotion._use_fused_block = real_call, real_fused


def _taps_of(state):
    return state["intermediates"]["pretrained"]["__call__"][0]


def _assert_model(got, taps, want, want_taps):
    """Disparities within TOL of max(1, the scale's largest |disparity|):
    without the conv head and its sigmoid (the shipped flags) they reach
    5.9 here, where the port's own unmerged and merged Dash forwards, the
    same function summed in another order, differ by 1.0e-5."""
    for s in range(4):
        g, w = got[("disp", s)].numpy(), np.asarray(want[("disp", s)])
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= TOL * max(1.0, np.abs(w).max()), (s, err, np.abs(w).max())
    assert len(taps) == len(want_taps) == 4
    for (tok, cls), (jtok, jcls) in zip(taps, want_taps):
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=TAP_TOL, rtol=TAP_TOL)
        np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=TAP_TOL, rtol=TAP_TOL)


def _port_forward(model, x):
    taps = []
    hook = model.pretrained.register_forward_hook(lambda mod, inp, out: taps.extend(out))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    hook.remove()
    return got, taps


# "dash2": Dash in its phase 2
@pytest.mark.parametrize("case", ["ssb", "dash", "dash2"])
def test_endodav_lora_variant_matches_jax(case):
    """Full-width vits EndoDAV at 28x42, T=2, every motion module's GEGLU
    out-projection adapted too (``temporal_lora``)."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    phase2 = case == "dash2"
    cfg = dict(SHIPPED, lora_type="ssb" if case == "ssb" else "dash", image_shape=(28, 42),
               temporal_lora=True)
    x = np.random.default_rng(1).uniform(0.05, 0.95, (1, 2, 32, 40, 3)).astype(np.float32)
    jm = JEndoDAV(**cfg)
    var = _weights(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed=2)
    with tpu_route():
        want, state = jax.jit(lambda v, a: jm.apply(
            v, a, False, phase2, capture_intermediates=lambda mdl, _: mdl.name == "pretrained",
            mutable=["intermediates"]))(var, jnp.asarray(x))
    tm = EndoDAV(**cfg).eval()
    tm.load_state_dict(from_jax_params(var["params"]), strict=True)
    set_dash_phase2(tm, phase2)
    got, taps = _port_forward(tm, x)
    _assert_model(got, taps, want, _taps_of(state))
    if case != "ssb":  # the phase changes the output: the term is live
        set_dash_phase2(tm, not phase2)
        with torch.inference_mode():
            other = tm(torch.from_numpy(x))[("disp", 0)]
        assert (other - got[("disp", 0)]).abs().max() > 1e-3


def test_endodac_ssb_matches_jax():
    """EndoDAC vits with the shipped ssb flags at 28x28; a 5-D input
    flattened to its frames."""
    from endodav_tpu.models.endodac import EndoDAC as JEndoDAC

    cfg = dict(SHIPPED, image_shape=(28, 28))
    x = np.random.default_rng(3).uniform(0, 1, (1, 2, 32, 40, 3)).astype(np.float32)
    jm = JEndoDAC(backbone_size="vits", **cfg)
    var = _weights(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed=4)
    want, state = jax.jit(lambda v, a: jm.apply(
        v, a, capture_intermediates=lambda mdl, _: mdl.name == "pretrained",
        mutable=["intermediates"]))(var, jnp.asarray(x))
    tm = EndoDAC("vits", **cfg).eval()
    tm.load_state_dict(from_jax_params(var["params"], "endodac"), strict=True)
    got, taps = _port_forward(tm, x)
    _assert_model(got, taps, want, _taps_of(state))


def test_endodav_ssb_bf16_matches_jax():
    """bf16 EndoDAV with the shipped ssb flags at JAX's init weights: max
    2.5e-2, mean 4e-3 against JAX's bf16 on ("disp", 0), every scale in
    bf16, the port's mean error against JAX's f32 at most 1.5x JAX's own."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    cfg = dict(SHIPPED, image_shape=(56, 70))
    x = np.random.default_rng(5).uniform(0.05, 0.95, (1, 2, 64, 80, 3)).astype(np.float32)
    params = jax.jit(JEndoDAV(**cfg).init)(KEY, jnp.asarray(x))["params"]
    with tpu_route():
        run = lambda dt: jax.jit(lambda p, a: JEndoDAV(**cfg, dtype=dt).apply(  # noqa: E731
            {"params": p}, a))(params, jnp.asarray(x))
        w32, w16 = run(jnp.float32), run(jnp.bfloat16)
    tm = EndoDAV(**cfg).eval()
    tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    tm = tm.clone(dtype=torch.bfloat16)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for s in range(4):
        assert got[("disp", s)].dtype == torch.bfloat16 and w16[("disp", s)].dtype == jnp.bfloat16
    g = got[("disp", 0)].float().numpy()
    g16 = np.asarray(w16[("disp", 0)], np.float32)
    g32 = np.asarray(w32[("disp", 0)], np.float32)
    d = np.abs(g - g16)
    assert d.max() <= 2.5e-2 and d.mean() <= 4e-3, (d.max(), d.mean())
    own = np.abs(g16 - g32).mean()
    assert np.abs(g - g32).mean() <= 1.5 * own, (np.abs(g - g32).mean(), own)


# ------------------------------------------------ the video eval CLI


@pytest.fixture(scope="module")
def ssb_eval(tmp_path_factory):
    """A synthetic SCARED tree (one 40-frame 32x40 sequence of smooth frames
    and depths through cv2, in a split directory of its own), JAX EndoDAV
    ssb weights (``--temporal_lora``, the shipped flags otherwise) as a
    reference ``depth_model.pth``, and JAX's `evaluate_depth_video` on them
    (its TPU route)."""
    import cv2

    from endodav_tpu import native
    from endodav_tpu.cli import evaluate_depth_video as jcli
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV
    from endodav_tpu.options import EndoDAVOptions as JOptions

    root = tmp_path_factory.mktemp("ssb_eval")
    seq = "train/dataset5/keyframe1"
    n, h, w = 40, 32, 40
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = root / "data" / seq / "data"
    for sub in ("left", "scene_points", "frame_data"):
        os.makedirs(base / sub)
    for i in range(n):
        img = np.stack([128 + 100 * np.sin(6 * xx + 4 * yy + 0.05 * i + c) for c in range(3)],
                       axis=-1).astype(np.uint8)
        cv2.imwrite(str(base / "left" / f"{i:06d}.png"), img)
        depth = (40 + 30 * yy + 10 * np.cos(3 * xx + 0.03 * i)).astype(np.float32)
        cv2.imwrite(str(base / "scene_points" / f"scene_points{i:06d}.tiff"),
                    np.stack([depth, depth, depth], axis=-1))
        pose = np.eye(4)
        pose[0, 3] = 0.01 * i
        with open(base / "frame_data" / f"frame_data{i:06d}.json", "w") as f:
            json.dump({"camera-pose": pose.tolist()}, f)
    splits = root / "splits"
    os.makedirs(splits / "scared_video")
    (splits / "scared_video" / "val_files.txt").write_text(seq + "\n")
    folder = root / "weights"
    os.makedirs(folder)
    jm = JEndoDAV(**SHIPPED, image_shape=(28, 42), temporal_lora=True)
    var = _weights(jax.eval_shape(jm.init, KEY, jnp.zeros((1, 2, 28, 42, 3))), seed=6)
    torch.save(from_jax_params(var["params"]), folder / "depth_model.pth")
    args = ["--data_path", str(root / "data"), "--lora_type", "ssb", "--temporal_lora",
            "--disable_residual_block", "--disable_conv_head", "--depth_image_shape", "28", "42",
            "--load_weights_folder", str(folder)]
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)  # both packages read through PIL
    mp.setattr(jengine, "SPLITS_DIR", str(splits))
    try:
        with tpu_route():
            want = jcli.evaluate(JOptions().parse(args))
    finally:
        mp.undo()
    return args, str(splits), want


@pytest.mark.parametrize("merge", [False, True])
def test_evaluate_depth_video_ssb_matches_jax(ssb_eval, merge, monkeypatch):
    """``python -m endodav_tpu_torch.cli.evaluate_depth_video --lora_type ssb
    ...`` as built and with ``--merge_lora`` against JAX's unmerged CLI: the
    per-frame depth errors within 1e-4 relative, mean TAE and TAS within
    1e-2 relative."""
    from endodav_tpu_torch.cli import evaluate_depth_video
    from endodav_tpu_torch.options import EndoDAVOptions

    args, splits, want = ssb_eval
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", splits)
    got = evaluate_depth_video.evaluate(EndoDAVOptions().parse(
        ["--no_cuda", *args, *(["--merge_lora"] if merge else [])]))
    assert got["all_errors"].shape == want["all_errors"].shape == (40, 7)
    np.testing.assert_allclose(got["all_errors"], want["all_errors"], rtol=METRIC_RTOL)
    # TAE/TAS reproject each depth map to whole pixels of the next: on these
    # 32x40 frames, depths whose errors agree to 6e-6 relative move one
    # frame's TAE by up to 11%, and the means by 0.2% (TAE) and 5e-4 (TAS)
    assert got["all_temporal"].shape == want["all_temporal"].shape == (39, 2)
    np.testing.assert_allclose(got["mean_temporal"], want["mean_temporal"], rtol=1e-2)


# ------------------------------------------------------------ training


def _dash_trainer(params):
    """The port's Trainer at `tests/test_torch_train_step.py`'s tiny
    configuration with ``--lora_type dash`` on the CPU, its depth model
    loaded from JAX ``params``."""
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer
    from test_torch_train_step import FLAGS

    t = Trainer(EndoDAVOptions().parse([*FLAGS, "--lora_type", "dash"]))
    t.mods["depth_model"].load_state_dict(from_jax_params(params), strict=True)
    return t


def test_dash_phase_boundary_matches_jax(tmp_path):
    """The trainer's boundary against JAX's `Trainer._maybe_dash_phase_boundary`
    (run on a stand-in for its trainer) on the same depth weights, LoRA B
    nonzero: nothing at step 99; at step 100 every Dash layer's (fc1, fc2
    and, with ``--temporal_lora`` off, no motion module's) u_top · diag(index)
    · vt_top as JAX's and phase 2 switched on.  Then one step in phase 2:
    ``lora_index`` trains (Adam stepped it), ``weight_u_top`` and
    ``weight_vt_top`` stay as the boundary left them."""
    import types

    from flax.traverse_util import flatten_dict

    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV
    from endodav_tpu.train.trainer import Trainer as JTrainer
    from endodav_tpu_torch.models.lora import LoRADense, dash_phase2_of
    from test_torch_train_step import exact_cpu_convs, make_batch  # noqa: F401

    jm = JEndoDAV(encoder="vits", lora_type="dash", image_shape=(28, 42),
                  residual_block_indexes=(1,))
    params = _weights(jax.eval_shape(jm.init, KEY, jnp.zeros((1, 2, 28, 42, 3))), seed=7)["params"]
    for leaf in ("lora_index", "weight_u_top", "weight_vt_top"):  # the training init: zero
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: np.zeros_like(a) if jax.tree_util.keystr(p).endswith(f"'{leaf}']") else a,
            params)
    port = _dash_trainer(params)
    built = []
    stand_in = types.SimpleNamespace(
        opt=types.SimpleNamespace(lora_type="dash"), dash_phase2=False, dash_warmup=100,
        variables={"depth_model": {"params": params}},
        _build_step=lambda dash_phase2: built.append(dash_phase2))
    for step in (99, 100):
        stand_in.step = port.step = step
        JTrainer._maybe_dash_phase_boundary(stand_in)
        port._maybe_dash_phase_boundary()
        assert port.dash_phase2 == stand_in.dash_phase2 == (step == 100)
        assert dash_phase2_of(port.mods["depth_model"]) == (step == 100)
    assert built == [True]
    jflat = flatten_dict(stand_in.variables["depth_model"]["params"])
    dash = {n: m for n, m in port.mods["depth_model"].named_modules()
            if isinstance(m, LoRADense) and m.variant == "dash"}
    assert len(dash) == 24
    rng = np.random.default_rng(8)
    for name, m in dash.items():
        i, fc = name.split(".")[2], name.split(".")[-1]
        jl = {k[-1]: np.asarray(v) for k, v in jflat.items()
              if k[:-1] == ("pretrained", f"blocks_{i}", "mlp", fc)}
        idx = rng.standard_normal(8).astype(np.float32)
        got = (m.weight_u_top.detach().numpy() * idx) @ m.weight_vt_top.detach().numpy()
        want = (jl["weight_u_top"] * idx) @ jl["weight_vt_top"]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)
    m = dash["pretrained.blocks.0.mlp.fc1"]
    top = (m.weight_u_top.detach().clone(), m.weight_vt_top.detach().clone())
    with torch.backends.mkldnn.flags(enabled=False):
        scalars = port.train_one_batch(make_batch())
    assert np.isfinite(float(scalars["loss"]))
    assert int(port.opt_main.state_of(m.lora_index).get("step", 0)) == 1
    assert m.lora_index.detach().abs().max() > 0
    assert torch.equal(m.weight_u_top.detach(), top[0])
    assert torch.equal(m.weight_vt_top.detach(), top[1])
    assert not port.opt_main.state_of(m.weight_u_top)


def test_ssb_main_phase_losses_and_grads_match_jax():
    """The training step's main phase with ssb (`scripts/train_video.sh`'s
    adapter) at `tests/test_torch_train_step.py`'s tiny configuration:
    every loss term within 1e-4 relative, and the gradients of the first
    block's fc1 scale vectors (the spatial_ab group, trained from step 1)
    within 1e-3 of their largest entry, against JAX's `jax.grad`."""
    from endodav_tpu.train import losses as JL
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables
    from endodav_tpu_torch.train import losses as TL
    from endodav_tpu_torch.train import optim as TO
    from test_torch_train_step import (LOSS_RTOL, GRAD_RTOL, _assert_close_rel, _jax_opt,
                                       _loss_cfg, _port_trainer, _with_motion, make_batch)

    jopt = _jax_opt()
    jopt.lora_type = "ssb"
    mods = build_models(jopt)
    variables = _with_motion(init_variables(mods, jopt))
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    cfg = _loss_cfg()

    def loss_of(depth_params):
        v = dict(variables, depth_model=dict(variables["depth_model"], params=depth_params))
        loss, aux = JL.main_phase(mods, v, jbatch, cfg)
        return loss, aux["losses"]

    jgrad, jlosses = jax.jit(jax.grad(loss_of, has_aux=True))(variables["depth_model"]["params"])
    with torch.backends.mkldnn.flags(enabled=False):
        port = _port_trainer(variables, "ssb")
        tbatch = port.device_batch(batch)
        gates = TO.schedule_gates(1, port.sched_cfg)
        TO.set_trainable(port.main_mods, TO.gates_tree(port.groups, gates))
        tloss, aux = TL.main_phase(port.mods, tbatch, cfg)
        tloss.backward()
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    fc1 = port.mods["depth_model"].pretrained.blocks[0].mlp.fc1
    jfc1 = jgrad["pretrained"]["blocks_0"]["mlp"]["fc1"]
    for leaf in ("lora_A", "lora_B"):
        assert getattr(fc1, leaf).grad is not None, leaf
        _assert_close_rel(getattr(fc1, leaf).grad, jfc1[leaf], GRAD_RTOL)
