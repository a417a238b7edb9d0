"""The port's training step against the JAX package on the CPU, at the tiny
configuration of `tests/test_train_step.py` (32x64 frames, T=2, ViT input
28x42, full-depth vits with dvlora), with the JAX init converted into the
port by `utils/convert.py:from_jax_params`.

* phase 0: `position_phase_loss`, the gradients of every position-net
  parameter and the committed BatchNorm statistics;
* main phase: every term of `main_phase`'s loss dict;
* one whole step with dvlora and one with ssb (`slow`: the JAX step's jit
  takes about 100-200 s to compile on one CPU core): both losses and the
  updates (new value minus the initial one) of the LoRA B (ssb: both scale
  vectors), the conv_depth head, the pose decoder and the position
  decoder, and a frozen ViT weight, which must not move.

At the JAX init the flows are ~1e-5 px and the pose ~0, so every warp
samples at integer pixel positions, where the bilinear gradient jumps
and rounding picks the side; the tests therefore give the flow convs and
the pose head biases a visible motion (`_with_motion`) on both sides.

oneDNN's f32 convolution backward loses accuracy on CPUs where it runs
reduced-precision matrix units (measured: 4e-2 relative on a ResNet
weight gradient against float64, 7e-6 with it off), so the port's side
runs with `torch.backends.mkldnn` off.  The phase-0 gradients are held
against the JAX package run in float64: JAX's own float32 gradients of
the position encoder's lower stages (``layer2.1`` and below) differ from
its float64 ones by up to 5e-2 of their largest entry on such a CPU,
while the port's float32 gradients agree with them to 3e-5.

Tolerances: relative 1e-4 on losses (f32 sums through a 12-block ViT,
three ResNets and the U-Nets reassociate) and on the phase-0 gradients
against float64; the one-step updates within 1e-3 of their largest entry
(a skipped or reversed update misses by its own size, 1e3 times the
tolerance).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu_torch.utils.convert import (COMPONENT_KIND, decoder_rules, from_jax_params,
                                              resnet_encoder_rules)

torch.set_num_threads(1)

LOSS_RTOL, GRAD_RTOL, GRAD64_RTOL = 1e-4, 1e-3, 1e-4
B, T, H, W = 2, 2, 32, 64
SCALES = (0, 1, 2, 3)
FLAGS = ["--no_cuda", "--data_path", "/nonexistent", "--height", str(H), "--width", str(W),
         "--batch_size", str(B), "--T", str(T), "--depth_image_shape", "28", "42",
         "--residual_block_indexes", "1", "--warm_up_step", "5", "--depth_reproj", "0.01",
         "--depth_flow", "0.01", "--num_workers", "1"]


def _jax_opt():
    return types.SimpleNamespace(
        data_path="/nonexistent", log_dir=None, encoder="vits", pre_norm=False,
        inv_sigmoid=False, out_sigmoid=False, pretrained_path=None, lora_type="dvlora",
        lora_rank=4, warm_up_step=5, tune_depth_interval=-1, temporal_lora=False,
        tune_temporal_interval=100, tune_spatial_interval=300, disable_residual_block=False,
        disable_conv_head=False, residual_block_indexes=[1], include_cls_token=True,
        learn_intrinsics=True, model_type="endodav", num_layers=18, height=H, width=W,
        depth_reproj=0.01, depth_flow=0.01, disparity_smoothness=1e-3,
        position_smoothness=1e-3, transform_constraint=0.01, transform_smoothness=0.01,
        scales=list(SCALES), min_depth=0.1, max_depth=150.0, use_stereo=False,
        frame_ids=[0, -1, 1], frame_max_interval=1, random_train=False,
        train_output_conv=False, batch_size=B, T=T, learning_rate=1e-4, num_epochs=1,
        scheduler_step_size=10, no_ssim=False, weights_init="scratch",
        pose_model_input="pairs", pose_model_type="separate_resnet", num_workers=0,
        load_weights_folder=None, models_to_load=[], log_frequency=400,
        depth_align="scale_shift", pred_depth_scale_factor=1.0, chunk_windows=1,
        compute_dtype="float32", depth_image_shape=(28, 42), eval_split="scared_video",
        mesh_shape="data=1")


def make_batch(seed=314):
    """Loader-shaped batch [B, T, ...] (as tests/test_train_step.py)."""
    from endodav_tpu_torch.data.pipeline import scaled_intrinsics

    rng = np.random.default_rng(seed)
    batch = {}
    for fi in (0, -1, 1):
        for s in SCALES:
            arr = rng.uniform(0.1, 0.9, (B, T, H // 2 ** s, W // 2 ** s, 3)).astype(np.float32)
            batch[("color", fi, s)] = arr
            batch[("color_aug", fi, s)] = arr + rng.normal(0, 0.01, arr.shape).astype(np.float32)
    for s in SCALES:
        K, iK = scaled_intrinsics(W, H, s)
        batch[("K", s)] = np.broadcast_to(K, (B, T, 4, 4)).copy()
        batch[("inv_K", s)] = np.broadcast_to(iK, (B, T, 4, 4)).copy()
    return batch


def _with_motion(variables, seed=21):
    """Flows of ~0.7 px and a small camera motion: biases of the
    position convs and of the pose head drawn from the seed."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(lambda a: a, variables)
    pos = dict(v["position"]["params"])
    for s in SCALES:
        if f"position_conv_{s}" not in pos:  # a model trained at fewer scales
            continue
        conv = dict(pos[f"position_conv_{s}"])
        conv["bias"] = jnp.asarray(rng.normal(0, 0.7, conv["bias"].shape).astype(np.float32))
        pos[f"position_conv_{s}"] = conv
    pose = dict(v["pose"]["params"])
    pose["pose_2"] = dict(pose["pose_2"], bias=jnp.asarray(
        rng.normal(0, 10.0, pose["pose_2"]["bias"].shape).astype(np.float32)))
    v["position"] = dict(v["position"], params=pos)
    v["pose"] = dict(v["pose"], params=pose)
    return v


def _port_trainer(variables, lora_type="dvlora", num_layers=18):
    """The port's Trainer on the CPU with the JAX variables loaded."""
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    t = Trainer(EndoDAVOptions().parse([*FLAGS, "--lora_type", lora_type, "--num_layers",
                                        str(num_layers)]))
    for comp, kind in COMPONENT_KIND.items():
        v = jax.tree_util.tree_map(np.asarray, variables[comp])
        t.mods[comp].load_state_dict(
            from_jax_params(v["params"], kind, v.get("batch_stats")), strict=True)
    return t


def _loss_cfg():
    return dict(scales=SCALES, height=H, width=W, T=T, batch_size=B, min_depth=0.1,
                max_depth=150.0, no_ssim=False, learn_intrinsics=True, transform_constraint=0.01,
                transform_smoothness=0.01, disparity_smoothness=1e-3, position_smoothness=1e-3,
                depth_reproj=0.01, depth_flow=0.01, train=True)


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def setup(exact_cpu_convs):
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables

    jopt = _jax_opt()
    mods = build_models(jopt)
    variables = _with_motion(init_variables(mods, jopt))
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    port = _port_trainer(variables)
    return mods, variables, jbatch, port, port.device_batch(batch)


def _assert_close_rel(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= rtol * scale, (np.abs(got - want).max(), scale)


def test_position_phase_loss_grads_and_stats_match_jax(setup):
    """The phase-0 loss against JAX in float32, the gradient of every
    parameter of both position nets against JAX in float64, and the
    committed BatchNorm statistics."""
    from flax.traverse_util import flatten_dict

    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.models.resnet import commit_batch_stats
    from endodav_tpu_torch.train import losses as TL
    from endodav_tpu_torch.train import optim as TO
    from endodav_tpu_torch.utils.convert import _INVERSE

    mods, variables, jbatch, port, tbatch = setup

    def loss0_of(mods_, variables_, batch_):
        def loss0(pp):
            v = dict(variables_)
            v["position_encoder"] = {"params": pp["position_encoder"],
                                     "batch_stats": variables_["position_encoder"]["batch_stats"]}
            v["position"] = {"params": pp["position"]}
            out, stats = JL.forward_flow_nets(mods_, v, batch_, SCALES, (H, W), True, False)
            return JL.position_phase_loss(out, batch_, SCALES, 1e-3, True), stats
        return loss0

    pp = {k: variables[k]["params"] for k in ("position_encoder", "position")}
    jl, jstats = jax.jit(loss0_of(mods, variables, jbatch))(pp)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        mods64 = dict(mods, position_encoder=mods["position_encoder"].clone(dtype=jnp.float64),
                      position=mods["position"].clone(dtype=jnp.float64))
        jg = jax.jit(jax.grad(loss0_of(mods64, f64(variables), f64(jbatch)), has_aux=True))(
            f64(pp))[0]
        jg = jax.tree_util.tree_map(np.asarray, jg)

    TO.set_trainable(port.main_mods, None)
    TO.set_trainable(port.pos_mods, port.all_pos)
    out = TL.forward_flow_nets(port.mods, tbatch, SCALES, (H, W), True, False)
    tl = TL.position_phase_loss(out, tbatch, SCALES, 1e-3, True)
    port.opt_pos.zero_grad()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for comp, rules in (("position_encoder", resnet_encoder_rules()),
                        ("position", decoder_rules())):
        flat = flatten_dict(jg[comp])
        rule = {t: (f, layout) for t, f, layout in rules}
        for name, prm in port.mods[comp].named_parameters():
            f, layout = rule[name]
            _assert_close_rel(prm.grad, _INVERSE[layout](flat[f]), GRAD64_RTOL)
    enc = port.mods["position_encoder"]
    commit_batch_stats(enc)
    js = jstats["position_encoder"]
    np.testing.assert_allclose(enc.encoder.bn1.running_var.numpy(), np.asarray(js["bn1"]["var"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(enc.encoder.layer2[0].bn2.running_mean.numpy(),
                               np.asarray(js["layer2_0"]["bn2"]["mean"]), rtol=1e-4, atol=1e-5)
    # put the port back where it started for the next test
    v = jax.tree_util.tree_map(np.asarray, variables["position_encoder"])
    port.mods["position_encoder"].load_state_dict(
        from_jax_params(v["params"], "resnet_encoder", v["batch_stats"]))


def test_main_phase_losses_match_jax(setup):
    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.train import losses as TL

    mods, variables, jbatch, port, tbatch = setup
    cfg = _loss_cfg()
    jlosses = jax.jit(lambda v: JL.main_phase(mods, v, jbatch, cfg)[1]["losses"])(variables)
    with torch.no_grad():
        tloss, aux = TL.main_phase(port.mods, tbatch, cfg)
    assert set(aux["losses"]) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    # drop the batch statistics the train-mode encoders recorded
    for m in port.mods.values():
        for bn in m.modules():
            if hasattr(bn, "pending"):
                bn.pending = None


def _one_step_against_jax(tmp_path, lora_type, adapter_leaves, new_value_ulp=False):
    """One whole step of the JAX trainer and of the port's on the same
    variables and batch, both built with ``lora_type``: both losses, and
    the updates of the first block's fc1 adapter leaves ``adapter_leaves``,
    the conv_depth head, the pose decoder and the position decoder, and a
    frozen ViT weight, which must not move.  ``new_value_ulp`` also allows
    each entry one rounding of its new value: ssb's vectors sit near 1,
    where f32 resolves their ~1e-5 updates only to 1.2e-7."""
    from flax.traverse_util import flatten_dict

    from endodav_tpu.train.trainer import Trainer as JTrainer

    jopt = _jax_opt()
    jopt.log_dir = str(tmp_path)
    jopt.lora_type = lora_type
    jt = JTrainer(jopt)
    jt.variables = _with_motion(jt.variables)
    port = _port_trainer(jt.variables, lora_type)
    init = jax.tree_util.tree_map(np.array, jt.variables)  # copies: the step may donate
    batch = make_batch()
    jsc = jt.train_one_batch(batch)
    tsc = port.train_one_batch(batch)
    np.testing.assert_allclose(float(tsc["loss"]), float(jsc["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tsc["loss_0"]), float(jsc["loss_0"]), rtol=LOSS_RTOL)
    def jax_param(variables, comp, *path):
        return np.asarray(flatten_dict(variables[comp]["params"])[path])

    tdm = dict(port.mods["depth_model"].named_parameters())
    to_jax = {"conv": lambda t: t.permute(2, 3, 1, 0), "linear": lambda t: t.T,
              "plain": lambda t: t}
    checks = [  # (port parameter, its optimizer, layout, JAX component and path)
        *((tdm[f"pretrained.blocks.0.mlp.fc1.{leaf}"], port.opt_main, "plain",
           ("depth_model", "pretrained", "blocks_0", "mlp", "fc1", leaf))
          for leaf in adapter_leaves),
        (tdm["head.conv_depth_1.head.0.weight"], port.opt_main, "conv",
         ("depth_model", "head", "conv_depth_1", "conv0", "kernel")),
        (tdm["pretrained.blocks.0.mlp.fc1.weight"], port.opt_main, "linear",
         ("depth_model", "pretrained", "blocks_0", "mlp", "fc1", "kernel")),
        (port.mods["pose"].convs["pose_2"].weight, port.opt_main, "conv",
         ("pose", "pose_2", "kernel")),
        (port.mods["position"].convs["position_conv_0"].weight, port.opt_pos, "conv",
         ("position", "position_conv_0", "kernel")),
    ]
    for prm, opt, layout, path in checks:
        before = jax_param(init, *path)
        want = jax_param(jt.variables, *path) - before
        got = to_jax[layout](prm.detach()).numpy() - before
        state = opt.state_of(prm)
        if not state:  # frozen: neither side moves
            assert not want.any() and not got.any(), path
            continue
        # Adam's first step moves an entry by u = lr * g / (|g| + eps), so
        # a gradient difference dg moves it by lr * eps * dg / (|g| + eps)^2.
        # The two sides' gradients agree to 1e-3 of their largest entry,
        # which at an entry 100x smaller leaves u free by several per cent
        # (and lets a g near 0 take either sign); the updates are compared
        # where the gradient (Adam's first moment) is above 0.1 of its
        # largest entry, within 1e-3 of the update's largest
        m = to_jax[layout](state["exp_avg"].abs()).numpy()
        sure = m > 0.1 * m.max()
        assert want[sure].any(), path  # JAX's step moved it
        if new_value_ulp:
            slack = np.spacing(np.abs(before[sure]).astype(np.float32))
            bound = GRAD_RTOL * np.abs(want[sure]).max() + slack
            assert np.all(np.abs(got[sure] - want[sure]) <= bound), path
        else:
            _assert_close_rel(got[sure], want[sure], GRAD_RTOL)


@pytest.mark.slow
def test_one_step_matches_jax(exact_cpu_convs, tmp_path):
    _one_step_against_jax(tmp_path, "dvlora", ("lora_B",))


@pytest.mark.slow
def test_one_ssb_step_matches_jax(exact_cpu_convs, tmp_path):
    """The step with ssb, the adapter of `scripts/train_video.sh`: both of
    fc1's scale vectors train (as slow as the dvlora step: JAX's jit)."""
    _one_step_against_jax(tmp_path, "ssb", ("lora_A", "lora_B"), new_value_ulp=True)
