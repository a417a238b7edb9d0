"""Port parity of the training path's modules on the CPU, against the JAX
package at small sizes: the ResNet encoder with flax BatchNorm, the four
decoders, the on-device pyramid and jitter, the geometry and loss terms,
the schedule groups and gates, gated Adam, the weight converter for all
eight trainer components and the motion modules' training route.

Inputs and weights come from numpy seeds; JAX weights reach the port
through `utils/convert.py:from_jax_params`.  Tolerances: 1e-5 where the
two sides do the same f32 arithmetic in another order, 1e-4 through the
deeper stacks (ResNet, U-Net decoders) where f32 convolution sums
reassociate over many layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TOL, DEEP_TOL = 1e-5, 1e-4


def _randomize(params, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * scale).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), atol=tol, rtol=tol)


# ------------------------------------------------------------ ResNet + BN


def test_resnet_encoder_train_mode_and_batch_stats_match_flax():
    """Outputs in train mode, and the stored statistics after two
    applications, each committed (momentum 0.9, biased variance)."""
    from endodav_tpu.models.resnet import ResNetEncoder as JResNet
    from endodav_tpu_torch.models.resnet import ResNetEncoder, commit_batch_stats

    rng = np.random.default_rng(0)
    x1, x2 = (rng.uniform(0, 1, (2, 32, 64, 6)).astype(np.float32) for _ in range(2))
    jm = JResNet(18, num_input_images=2)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), train=False)
    params = _randomize(v["params"], 1, scale=0.1)
    stats = v["batch_stats"]
    tm = ResNetEncoder(18, num_input_images=2)
    tm.load_state_dict(from_jax_params(_np(params), "resnet_encoder", _np(stats)), strict=True)
    for x in (x1, x2):
        want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = tm(torch.from_numpy(x), train=True)
        commit_batch_stats(tm)
        for g, w in zip(got, want):
            _close(g, w, DEEP_TOL)
    sd = tm.state_dict()
    _close(sd["encoder.bn1.running_var"], stats["bn1"]["var"], TOL)
    _close(sd["encoder.layer3.0.downsample.1.running_mean"],
           stats["layer3_0"]["downsample_bn"]["mean"], DEEP_TOL)
    _close(sd["encoder.layer4.1.bn2.running_var"], stats["layer4_1"]["bn2"]["var"], DEEP_TOL)
    # eval mode reads the stored statistics
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x1), train=False)
    _close(tm(torch.from_numpy(x1), train=False)[-1], want[-1], DEEP_TOL)


def test_only_the_last_train_application_updates_the_statistics():
    from endodav_tpu_torch.models.resnet import BatchNorm, commit_batch_stats

    bn = BatchNorm(3)
    x1, x2 = torch.randn(2, 4, 5, 3), torch.randn(2, 4, 5, 3) * 2 + 1
    bn(x1, train=True)
    bn(x2, train=True)
    commit_batch_stats(bn)
    mean = x2.mean((0, 1, 2))
    var = (x2 * x2).mean((0, 1, 2)) - mean * mean
    _close(bn.running_mean, 0.1 * mean.numpy())
    _close(bn.running_var, 0.9 + 0.1 * var.numpy())


# ------------------------------------------------------------ decoders


def _resnet_feats(rng, b=2, h=32, w=64):
    chans, out = (64, 64, 128, 256, 512), []
    for i, c in enumerate(chans):
        out.append(rng.standard_normal((b, h // 2 ** (i + 1), w // 2 ** (i + 1), c))
                   .astype(np.float32))
    return out


@pytest.mark.parametrize("name", ["position", "transform"])
def test_unet_decoders_match_jax(name):
    from endodav_tpu.models import decoders as jdec
    from endodav_tpu_torch.models import decoders as tdec

    rng = np.random.default_rng(2)
    feats = _resnet_feats(rng)
    jcls, tcls = {"position": (jdec.PositionDecoder, tdec.PositionDecoder),
                  "transform": (jdec.TransformDecoder, tdec.TransformDecoder)}[name]
    jm = jcls((64, 64, 128, 256, 512), (0, 1, 2, 3))
    p = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])["params"], 3,
                   scale=0.05)
    want = jm.apply({"params": p}, [jnp.asarray(f) for f in feats])
    tm = tcls((64, 64, 128, 256, 512), (0, 1, 2, 3))
    tm.load_state_dict(from_jax_params(_np(p), "decoder"), strict=True)
    got = tm([torch.from_numpy(f) for f in feats])
    for k in want:
        _close(got[k], want[k], DEEP_TOL)


def test_pose_decoder_and_intrinsics_head_match_jax():
    from endodav_tpu.models.decoders import IntrinsicsHead as JK, PoseDecoder as JPose
    from endodav_tpu_torch.models.decoders import IntrinsicsHead, PoseDecoder

    rng = np.random.default_rng(4)
    last = rng.standard_normal((2, 1, 2, 512)).astype(np.float32)
    jm = JPose(2)
    p = _randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(last)])["params"], 5, scale=0.05)
    want = jm.apply({"params": p}, [jnp.asarray(last)])
    tm = PoseDecoder(512, 2)
    tm.load_state_dict(from_jax_params(_np(p), "decoder"), strict=True)
    got = tm([torch.from_numpy(last)])
    for g, w in zip(got, want):
        _close(g, w)
    jk = JK()
    pk = _randomize(jk.init(jax.random.PRNGKey(1), want[2], 64, 32)["params"], 6, scale=0.05)
    tk = IntrinsicsHead(256)
    tk.load_state_dict(from_jax_params(_np(pk), "decoder"), strict=True)
    _close(tk(got[2], 64, 32), jk.apply({"params": pk}, want[2], 64, 32), 1e-4)


# ------------------------------------------------------ pyramid + jitter


@pytest.mark.parametrize("order,factors", [([2, 0, 3, 1], [1.1, 0.85, 1.15, 0.07]),
                                           ([0, 1, 2, 3], [1.0, 1.0, 1.0, 0.0])])
def test_device_pyramid_and_jitter_match_jax(order, factors):
    from endodav_tpu.ops.jitter import device_pyramid as jpyr
    from endodav_tpu_torch.ops.jitter import device_pyramid as tpyr

    x = np.random.default_rng(7).uniform(0, 1, (3, 32, 64, 3)).astype(np.float32)
    o, f = np.asarray(order, np.int32), np.asarray(factors, np.float32)
    jc, ja = jpyr(jnp.asarray(x), 4, jnp.asarray(o), jnp.asarray(f))
    tc, ta = tpyr(torch.from_numpy(x), 4, o, torch.from_numpy(f))
    for s in range(4):
        _close(tc[s], jc[s])
        _close(ta[s], ja[s])


# ------------------------------------------------------ geometry + losses


def test_geometry_matches_jax():
    from endodav_tpu.geometry import transforms as J
    from endodav_tpu_torch.geometry import transforms as T

    rng = np.random.default_rng(8)
    aa = rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    tr = rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    for inv in (False, True):
        _close(T.transformation_from_parameters(torch.from_numpy(aa), torch.from_numpy(tr), inv),
               J.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr), inv))
    depth = rng.uniform(1, 50, (3, 8, 12, 1)).astype(np.float32)
    K = np.tile(np.array([[10, 0, 6, 0], [0, 9, 4, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32), (3, 1, 1))
    iK = np.linalg.inv(K).astype(np.float32)
    Tm = np.asarray(J.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr)))
    jp = J.backproject_depth(jnp.asarray(depth), jnp.asarray(iK))
    tp = T.backproject_depth(torch.from_numpy(depth), torch.from_numpy(iK))
    _close(tp, jp, 1e-4)
    jg, jz = J.project_3d(jp, jnp.asarray(K), jnp.asarray(Tm), 8, 12)
    tg, tz = T.project_3d(tp, torch.from_numpy(K), torch.from_numpy(Tm), 8, 12)
    _close(tg, jg, 1e-4)
    _close(tz, jz, 1e-4)


def test_loss_terms_match_jax():
    from endodav_tpu.geometry import losses as J
    from endodav_tpu_torch.geometry import losses as T

    rng = np.random.default_rng(9)
    a, b = (rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32) for _ in range(2))
    d = rng.uniform(0.1, 1, (2, 12, 16, 1)).astype(np.float32)
    m = (rng.uniform(0, 1, (2, 12, 16, 1)) > 0.3).astype(np.float32)
    ja, jb, jd, jm = map(jnp.asarray, (a, b, d, m))
    ta, tb, td, tm = map(torch.from_numpy, (a, b, d, m))
    _close(T.ssim(ta, tb), J.ssim(ja, jb))
    for use_ssim in (True, False):
        _close(T.reprojection_loss(ta, tb, use_ssim), J.reprojection_loss(ja, jb, use_ssim))
    _close(T.smooth_loss(td, ta), J.smooth_loss(jd, ja))
    _close(T.smooth_bright(ta, tb, ta * 0.5, tm), J.smooth_bright(ja, jb, ja * 0.5, jm))
    _close(T.smooth_registration(ta[..., :2]), J.smooth_registration(ja[..., :2]))
    _close(T.ncc(ta[..., :1], tb[..., :1]), J.ncc(ja[..., :1], jb[..., :1]), 1e-4)


def test_loss_gradients_match_jax_at_ties():
    """Exactly equal neighbours (the at-init flows) and pixels where the
    prediction equals its target: `jnp.abs` has gradient +1 at 0 and
    `jnp.clip` 0.5 at its bounds, where torch's give 0 and 1."""
    from endodav_tpu.geometry import losses as J
    from endodav_tpu_torch.geometry import losses as T

    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    disp = np.repeat(rng.uniform(0.1, 1, (2, 12, 4, 2)), 4, axis=2).astype(np.float32)
    target = img.copy()
    target[:, ::2] = rng.uniform(0, 1, target[:, ::2].shape)
    for jfn, tfn, x in (
            (lambda d: J.smooth_loss(d, jnp.asarray(img)),
             lambda d: T.smooth_loss(d, torch.from_numpy(img)), disp),
            (lambda p: J.reprojection_loss(p, jnp.asarray(target)).sum(),
             lambda p: T.reprojection_loss(p, torch.from_numpy(target)).sum(), img),
            (lambda p: J.ssim(p, jnp.asarray(img)).sum(),
             lambda p: T.ssim(p, torch.from_numpy(img)).sum(), img)):
        want = jax.grad(jfn)(jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        tfn(t).backward()
        _close(t.grad, want, TOL)
    t = torch.tensor([0.0, 0.5, 1.0], requires_grad=True)
    T.clip_jax(t, 0.0, 1.0).sum().backward()
    _close(t.grad, jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray([0.0, 0.5, 1.0])))


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--no_cuda"):
        Trainer(EndoDAVOptions().parse(["--data_path", "/nonexistent"]))


# --------------------------------------------------- schedule + optimizer


def _flax_tree_of(model, rules):
    """The flax param tree that the rule table maps the port's parameters to."""
    by_torch = {t: f for t, f, _ in rules}
    tree = {}
    for name, _ in model.named_parameters():
        node = tree
        *path, leaf = by_torch[name]
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = name
    return tree


# the ids of the dvlora cases are the conv_head flag's
GROUP_CASES = [pytest.param(True, "dvlora", id="True"), pytest.param(False, "dvlora", id="False"),
               pytest.param(True, "ssb", id="ssb"), pytest.param(False, "dash", id="dash"),
               pytest.param(True, "flora", id="flora")]
VARIANT_GROUPS = {"dvlora": {"spatial_ab", "spatial_uv", "temporal_ab", "temporal_uv"},
                  "ssb": {"spatial_ab", "temporal_ab"}, "flora": {"spatial_ab", "temporal_ab"},
                  "dash": {"spatial_ab", "temporal_ab", "dash_index"}}


@pytest.mark.parametrize("conv_head,lora_type", GROUP_CASES)
def test_assign_groups_equal_jax_groups_through_the_rule_tables(conv_head, lora_type):
    from endodav_tpu.train import optim as JO
    from endodav_tpu_torch.models.decoders import PoseDecoder
    from endodav_tpu_torch.models.endodav import EndoDAV
    from endodav_tpu_torch.train import optim as TO
    from endodav_tpu_torch.utils.convert import decoder_rules, endodav_rules

    depth = EndoDAV("vits", lora_type=lora_type, residual_block_indexes=(2, 5),
                    temporal_lora=True, conv_head=conv_head)
    pose = PoseDecoder(512, 2)
    got = TO.assign_groups({"depth_model": depth, "pose": pose})
    jtrees = {"depth_model": _flax_tree_of(depth, endodav_rules()),
              "pose": _flax_tree_of(pose, decoder_rules())}
    jgroups = JO.assign_groups(jtrees)
    names = jax.tree_util.tree_leaves(jtrees)
    labels = jax.tree_util.tree_leaves(jgroups)
    want = {}
    for comp in jtrees:
        n = jax.tree_util.tree_leaves(jtrees[comp])
        g = jax.tree_util.tree_leaves(jgroups[comp])
        want[comp] = dict(zip(n, g))
    assert len(names) == len(labels)
    assert got == want
    assert VARIANT_GROUPS[lora_type] | {"adapt", "frozen"} <= set(got["depth_model"].values())


@pytest.mark.parametrize("cfg", [
    dict(lora_type="dvlora", warm_up_step=2, tune_depth_interval=-1, temporal_lora=True,
         tune_spatial_interval=400, tune_temporal_interval=100, train_output_conv=False),
    dict(lora_type="dvlora", warm_up_step=10, tune_depth_interval=3, temporal_lora=True,
         tune_spatial_interval=3, tune_temporal_interval=2, train_output_conv=True),
    dict(lora_type="lora", warm_up_step=5, tune_depth_interval=-1, temporal_lora=False,
         tune_spatial_interval=300, tune_temporal_interval=100, train_output_conv=False,
         legacy_frozen_groups=("spatial_uv", "temporal_ab", "temporal_uv")),
    dict(lora_type="dash", warm_up_step=5, tune_depth_interval=2, temporal_lora=True,
         tune_spatial_interval=3, tune_temporal_interval=2, train_output_conv=False),
    dict(lora_type="ssb", warm_up_step=5, tune_depth_interval=-1, temporal_lora=True,
         tune_spatial_interval=400, tune_temporal_interval=100, train_output_conv=False),
])
def test_schedule_gates_match_jax(cfg):
    """Every gate, Dash's ``dash_index`` included, in both Dash phases."""
    from endodav_tpu.train import optim as JO
    from endodav_tpu_torch.train import optim as TO

    for phase2 in (False, True):
        for step in range(0, 30):
            want = {k: float(v)
                    for k, v in JO.schedule_gates(jnp.asarray(step), cfg, phase2).items()}
            assert TO.schedule_gates(step, cfg, phase2) == want, (step, phase2)


def test_gated_adam_matches_jax_with_a_zero_gate():
    from endodav_tpu.train import optim as JO
    from endodav_tpu_torch.train import optim as TO

    rng = np.random.default_rng(10)
    p0 = {"a": rng.standard_normal(5).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(5).astype(np.float32) for k in p0} for _ in range(3)]
    gates = [{"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 1.0}, {"a": 0.0, "b": 1.0}]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = JO.init_adam(jp)
    mods = {"m": torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                         for k, v in p0.items()})}
    opt = TO.GatedAdam(mods)
    for g, gate in zip(grads, gates):
        jp, js = JO.gated_adam_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 1e-2,
                                      {k: jnp.asarray(v) for k, v in gate.items()})
        TO.set_trainable(mods, {"m": gate})
        opt.zero_grad()
        for k, prm in mods["m"].items():
            if prm.requires_grad:
                prm.grad = torch.from_numpy(g[k])
        opt.step(1e-2)
        for k, prm in mods["m"].items():
            _close(prm, jp[k], 1e-6)
    # the gated-off step left b's moments and count as they were
    assert float(js["count"]["b"]) == 2.0
    assert int(opt.state_of(mods["m"]["b"])["step"]) == 2


# ----------------------------------------------- converter, 8 components


def test_from_jax_params_loads_all_eight_components():
    import types

    from endodav_tpu.train.trainer import build_models as jbuild
    from endodav_tpu_torch.train.trainer import build_models as tbuild
    from endodav_tpu_torch.utils.convert import COMPONENT_KIND

    opt = types.SimpleNamespace(
        model_type="endodav", encoder="vits", lora_rank=4, lora_type="dvlora",
        depth_image_shape=(28, 42), disable_residual_block=False, residual_block_indexes=[1],
        include_cls_token=True, inv_sigmoid=False, temporal_lora=True, disable_conv_head=False,
        out_sigmoid=False, num_layers=18, scales=[0, 1, 2, 3], pose_model_type="separate_resnet",
        pose_model_input="pairs", compute_dtype="float32", height=32, width=64, T=2)
    jm, tm = jbuild(opt), tbuild(opt)
    assert set(jm) == set(tm) == set(COMPONENT_KIND)
    rng = jax.random.PRNGKey(0)
    img2 = jnp.zeros((1, 32, 64, 6))
    feats = [jnp.zeros((1, 32 // 2 ** (i + 1), 64 // 2 ** (i + 1), c))
             for i, c in enumerate((64, 64, 128, 256, 512))]
    args = {"depth_model": ((jnp.zeros((1, 2, 32, 64, 3)),), {}),
            "position_encoder": ((img2,), {"train": False}),
            "transform_encoder": ((img2,), {"train": False}),
            "pose_encoder": ((img2,), {"train": False}),
            "position": ((feats,), {}), "transform": ((feats,), {}),
            "pose": (([feats[-1]],), {}),
            "intrinsics_head": ((jnp.zeros((1, 2, 4, 256)), 64, 32), {})}
    for comp, kind in COMPONENT_KIND.items():
        a, kw = args[comp]
        v = jax.eval_shape(lambda k: jm[comp].init(k, *a, **kw), rng)
        params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), v["params"])
        stats = None
        if "batch_stats" in v:
            stats = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                           v["batch_stats"])
        sd = from_jax_params(params, kind, stats)
        tm[comp].load_state_dict(sd, strict=True)


# ------------------------------------------------- motion training route


def test_temporal_module_training_route_matches_jax():
    """train=True runs the unfused sub-block with LayerNorm eps 1e-6, as
    JAX's `TemporalModule(train=True)`; the weights are shared with the
    fused serving route."""
    from endodav_tpu.models.motion import TemporalModule as JTemporal
    from endodav_tpu_torch.models.motion import TRAIN_LN_EPS, TemporalModule

    assert TRAIN_LN_EPS == 1e-6
    rng = np.random.default_rng(11)
    frames = 4
    x = rng.standard_normal((2 * frames, 3, 5, 64)).astype(np.float32)
    jm = JTemporal(in_channels=64, zero_initialize=False, fused=False, lora_variant="dvlora",
                   lora_alpha=4.0)
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), frames)["params"], 12,
                   scale=0.1)
    # a tiny proj_in makes the attention LayerNorms' input variance (~1e-8)
    # small against their eps, so 1e-6 and 1e-5 give different outputs
    p = dict(p, proj_in={k: v * 1e-3 for k, v in p["proj_in"].items()})
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), frames, train=True))
    tm = TemporalModule(64, lora_variant="dvlora", lora_alpha=4.0)
    sd = {k[len("head.motion_modules.0."):]: v for k, v in from_jax_params(
        {"head": {"motion_modules_0": _np(p)}}).items()}
    tm.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x)
    got = tm(xt, frames, train=True)
    _close(got, want, 1e-5)
    assert not np.allclose(tm(xt, frames, train=False).detach().numpy(), want, atol=1e-5)
