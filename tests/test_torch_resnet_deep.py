"""ResNet-50, 101 and 152 (bottleneck blocks) in the port against the JAX
package on the CPU: the encoder's features and its train-mode BatchNorm
statistics, the weight bridge both ways with no leaf left over, AF-SfM and
the decoders at the bottleneck widths (a 2048-channel top map), and the
pose eval, which sizes its decoder from ``--num_layers``.

Weights are numpy draws (`test_torch_endodac._fan_in`: fan-in scaled
kernels, BatchNorm scales near 1 and variances in [0.5, 1.5]) on JAX's
variable shapes (`jax.eval_shape`, no init compile), carried to the port
by `utils/convert.py:from_jax_params`.

Tolerances, relative to the largest entry of each output.  Eval mode:
1e-5 at every depth (measured here against JAX in float64: the port's f32
within 1.5e-6 and JAX's own f32 within 9e-7, also at 152 blocks).  Train
mode: against JAX run in float64, 1e-3.  Each BatchNorm there divides by
its batch's own spread, which at a 64x64 input is taken over 8 values a
channel in layer4, so f32 rounding grows with depth: the port's f32 sits
3e-4 from float64 in ResNet-50's last map, JAX's own f32 1.7e-3 (measured
here), which is why JAX's f32 is not the reference there.  Eval mode on the
statistics the two train-mode passes stored, which carry that difference:
1e-4 (measured 1.7e-5).  Disparities
within 1e-5 (sigmoid outputs); the pose eval's statistics 1e-4 relative
(its ResNet-50 reassociates its sums over 16 blocks).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_endodac import KEY, _fan_in
from test_torch_train_loop import jax_opt, port_opt

from endodav_tpu_torch.utils.convert import from_jax_params, to_jax_params

torch.set_num_threads(1)

EVAL_TOL, TRAIN64_TOL, TRAIN_EVAL_TOL, DISP_TOL, POSE_RTOL = 1e-5, 1e-3, 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    """oneDNN's reduced-precision f32 convolutions off (see
    `tests/test_torch_train_step.py`)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _close_rel(got, want, rtol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _encoder_pair(depth, n_images, x, seed):
    from endodav_tpu.models.resnet import ResNetEncoder as JResNet
    from endodav_tpu_torch.models.resnet import ResNetEncoder

    jm = JResNet(depth, num_input_images=n_images)
    var = _fan_in(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed)
    tm = ResNetEncoder(depth, num_input_images=n_images)
    tm.load_state_dict(from_jax_params(var["params"], "resnet_encoder", var["batch_stats"]),
                       strict=True)
    return jm, var, tm


def test_num_ch_enc_matches_jax():
    from endodav_tpu.models.resnet import resnet_num_ch_enc as jch
    from endodav_tpu_torch.models.resnet import resnet_num_ch_enc

    for depth in (18, 34, 50, 101, 152):
        assert resnet_num_ch_enc(depth) == jch(depth)
    assert resnet_num_ch_enc(50) == (64, 256, 512, 1024, 2048)
    with pytest.raises(ValueError, match="ResNet-20"):
        resnet_num_ch_enc(20)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("n_images", [1, 2])
def test_resnet50_train_mode_and_batch_stats_match_jax(n_images):
    """Two train-mode applications, each committed (flax's momentum 0.9 and
    biased variance), against JAX in float64: the five maps each time, then
    the stored statistics of the stem, of a bottleneck's third BatchNorm
    and of the projections of layer1.0 (64 -> 256 channels at stride 1)
    and layer3.0; then eval mode on the statistics each side stored,
    against JAX's f32 within TRAIN_EVAL_TOL."""
    from endodav_tpu_torch.models.resnet import commit_batch_stats

    rng = np.random.default_rng(n_images)
    x1, x2 = (rng.uniform(0, 1, (2, 64, 64, 3 * n_images)).astype(np.float32)
              for _ in range(2))
    jm, var, tm = _encoder_pair(50, n_images, x1, seed=10 + n_images)
    with jax.enable_x64(True):
        jm64, stats = jm.clone(dtype=jnp.float64), _f64(var["batch_stats"])
        params = _f64(var["params"])
        apply64 = jax.jit(lambda v, a: jm64.apply(v, a, train=True, mutable=["batch_stats"]))
        for x in (x1, x2):
            want, mut = apply64({"params": params, "batch_stats": stats}, _f64(x))
            stats = mut["batch_stats"]
            got = tm(torch.from_numpy(x), train=True)
            commit_batch_stats(tm)
            assert [g.shape[-1] for g in got] == [64, 256, 512, 1024, 2048]
            for i, (g, w) in enumerate(zip(got, want)):
                _close_rel(g, np.asarray(w), TRAIN64_TOL, f"map {i}")
        stats = jax.tree_util.tree_map(np.asarray, stats)
    sd = tm.state_dict()
    for key, path in (("encoder.bn1.running_var", ("bn1", "var")),
                      ("encoder.layer1.0.downsample.1.running_mean",
                       ("layer1_0", "downsample_bn", "mean")),
                      ("encoder.layer2.3.bn3.running_var", ("layer2_3", "bn3", "var")),
                      ("encoder.layer3.0.downsample.1.running_var",
                       ("layer3_0", "downsample_bn", "var")),
                      ("encoder.layer4.2.bn3.running_mean", ("layer4_2", "bn3", "mean"))):
        node = stats
        for p in path:
            node = node[p]
        _close_rel(sd[key], node, TRAIN64_TOL, key)
    stats = jax.tree_util.tree_map(lambda a: a.astype(np.float32), stats)
    want = jm.apply({"params": var["params"], "batch_stats": stats}, jnp.asarray(x1),
                    train=False)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x1), train=False)
    for i, (g, w) in enumerate(zip(got, want)):
        _close_rel(g, w, TRAIN_EVAL_TOL, f"eval map {i}")


@pytest.mark.parametrize("depth", [101, 152])
def test_deeper_encoders_tree_and_forward_match_jax(depth):
    """JAX's variable tree (shapes by `jax.eval_shape`) through
    `from_jax_params` into the port's state dict, strictly (no key left on
    either side), and back through `to_jax_params` bit for bit; the five
    maps of one eval-mode forward on a small input within EVAL_TOL."""
    from endodav_tpu_torch.models.resnet import _LAYERS

    x = np.random.default_rng(depth).uniform(0, 1, (1, 64, 64, 6)).astype(np.float32)
    jm, var, tm = _encoder_pair(depth, 2, x, seed=depth)
    blocks = sum(_LAYERS[depth])
    assert len([k for k in tm.state_dict() if k.endswith("conv3.weight")]) == blocks
    back = to_jax_params(tm.state_dict(), "resnet_encoder")
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(a)  # noqa: E731
                      for p, a in jax.tree_util.tree_leaves_with_path(t)}
    want_leaves, got_leaves = flat(var), flat(back)
    assert set(got_leaves) == set(want_leaves)
    assert all(np.array_equal(got_leaves[k], v) for k, v in want_leaves.items())
    want = jm.apply(var, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), train=False)
    for i, (g, w) in enumerate(zip(got, want)):
        _close_rel(g, w, EVAL_TOL, f"ResNet-{depth} map {i}")


def test_afsfm_resnet50_matches_jax():
    """AF-SfM at ``--num_layers 50``: the depth U-Net on the 2048-channel
    pyramid, random BatchNorm statistics, four sigmoid scales."""
    from endodav_tpu.models.afsfm import AFSfMDepth as JAFSfM
    from endodav_tpu_torch.models.afsfm import AFSfMDepth

    x = np.random.default_rng(50).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jm = JAFSfM(num_layers=50)
    var = _fan_in(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed=51)
    want = jax.jit(lambda v, a: jm.apply(v, a))(var, jnp.asarray(x))
    tm = AFSfMDepth(50).eval()
    tm.load_state_dict(from_jax_params(var["params"], "afsfm", var["batch_stats"]), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for s in range(4):
        g, w = got[("disp", s)].numpy(), np.asarray(want[("disp", s)])
        assert g.shape == w.shape == (2, 64 // 2 ** s, 96 // 2 ** s, 1)
        np.testing.assert_allclose(g, w, atol=DISP_TOL, rtol=DISP_TOL, err_msg=f"scale {s}")


def _bottleneck_feats(rng, b=2, h=64, w=64):
    chans = (64, 256, 512, 1024, 2048)
    return [rng.standard_normal((b, h // 2 ** (i + 1), w // 2 ** (i + 1), c)).astype(np.float32)
            for i, c in enumerate(chans)]


@pytest.mark.parametrize("name", ["depth", "position", "transform", "pose"])
def test_decoders_at_bottleneck_widths_match_jax(name):
    """The trainer's decoders built from `resnet_num_ch_enc(50)`, on five
    maps of the bottleneck widths; the pose decoder on the 2048-channel top
    map (`PoseDecoder(num_ch[-1])`, as `build_models` and the pose eval
    build it)."""
    from endodav_tpu.models import decoders as jdec
    from endodav_tpu_torch.models import decoders as tdec
    from endodav_tpu_torch.models.resnet import resnet_num_ch_enc

    num_ch, scales = resnet_num_ch_enc(50), (0, 1, 2, 3)
    feats = _bottleneck_feats(np.random.default_rng(7))
    jf = [jnp.asarray(f) for f in feats]
    if name == "pose":
        jm, tm = jdec.PoseDecoder(num_frames_to_predict_for=2), tdec.PoseDecoder(
            num_ch[-1], num_frames_to_predict_for=2)
        jf, tf = [jf[-1]], [torch.from_numpy(feats[-1])]
    else:
        jcls, tcls = {"depth": (jdec.DepthDecoder, tdec.DepthDecoder),
                      "position": (jdec.PositionDecoder, tdec.PositionDecoder),
                      "transform": (jdec.TransformDecoder, tdec.TransformDecoder)}[name]
        jm, tm = jcls(num_ch, scales), tcls(num_ch, scales)
        tf = [torch.from_numpy(f) for f in feats]
    var = _fan_in(jax.eval_shape(jm.init, KEY, jf), seed=8)
    want = jm.apply(var, jf)
    tm.load_state_dict(from_jax_params(var["params"], "decoder"), strict=True)
    with torch.inference_mode():
        got = tm(tf)
    pairs = (zip(got, want) if name == "pose"
             else ((got[k], want[k]) for k in want))
    n = 0
    for g, w in pairs:
        _close_rel(g, w, EVAL_TOL, name)
        n += 1
    assert n >= 3


def test_pose_eval_builds_the_decoder_of_its_depth(tmp_path):
    """`evaluate_pose_pairs` at ``--num_layers 50`` with no modules given:
    it builds ResNet-50 and `PoseDecoder(2048)` and loads them from a
    weights folder that JAX's `save_components` wrote; ATE, RE and the
    intrinsics within POSE_RTOL of JAX's own `evaluate_pose_pairs` on the
    same variables (ragged last batch of 5)."""
    from endodav_tpu.eval.engine import evaluate_pose_pairs as jpose
    from endodav_tpu.models.decoders import IntrinsicsHead as JK, PoseDecoder as JPose
    from endodav_tpu.models.resnet import ResNetEncoder as JResNet
    from endodav_tpu.utils import checkpoint as jckpt
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.models import decoders

    h, w = 64, 96
    pair = jnp.zeros((1, h, w, 6))
    enc, dec, intr = JResNet(50, num_input_images=2), JPose(num_frames_to_predict_for=2), JK()
    enc_v = _fan_in(jax.eval_shape(enc.init, KEY, pair), 20)
    top = jnp.zeros((1, 2, 3, 2048))
    pose_v = _fan_in(jax.eval_shape(dec.init, KEY, [top]), 21)
    intr_v = _fan_in(jax.eval_shape(intr.init, KEY, jnp.zeros((1, 2, 3, 256)), w, h), 22)
    folder = str(tmp_path / "weights")
    jckpt.save_components(folder, {"pose_encoder": enc_v, "pose": pose_v,
                                   "intrinsics_head": intr_v})
    args = ["--height", str(h), "--width", str(w), "--num_layers", "50",
            "--load_weights_folder", folder]
    rng = np.random.default_rng(23)
    pairs = rng.uniform(0, 1, (21, h, w, 6)).astype(np.float32)
    gt = np.stack([np.eye(4, dtype=np.float32)] * 21)
    gt[:, :3, 3] = rng.normal(0, 0.01, (21, 3))
    built = []
    real = decoders.PoseDecoder

    class Recording(real):
        def __init__(self, num_ch_enc, *a, **k):
            built.append(num_ch_enc)
            super().__init__(num_ch_enc, *a, **k)

    decoders.PoseDecoder = Recording
    try:
        got = engine.evaluate_pose_pairs(port_opt("--data_path", "/nonexistent", *args), gt,
                                         pairs)
    finally:
        decoders.PoseDecoder = real
    assert built == [2048]
    want = jpose(jax_opt("--data_path", "/nonexistent", *args), gt, pairs,
                 pose_modules=(enc, enc_v, dec, pose_v, intr, intr_v))
    for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=POSE_RTOL, err_msg=k)
    for k, v in want["intrinsics_stats"].items():
        np.testing.assert_allclose(got["intrinsics_stats"][k], v, rtol=POSE_RTOL, err_msg=k)


def test_num_layers_choices_match_jax():
    """``--num_layers`` takes JAX's five depths in `options.py` and in
    `cli/test_simple.py` (whose JAX parser takes any int), and refuses
    others in both of the port's parsers."""
    from endodav_tpu.options import EndoDAVOptions as JOptions
    from endodav_tpu_torch.cli import test_simple
    from endodav_tpu_torch.options import EndoDAVOptions

    jchoices = next(a.choices for a in JOptions().parser._actions if a.dest == "num_layers")
    port = next(a.choices for a in EndoDAVOptions().parser._actions if a.dest == "num_layers")
    assert port == jchoices == [18, 34, 50, 101, 152]
    for depth in jchoices:
        assert test_simple.parse_args(["--image_path", os.devnull, "--num_layers",
                                       str(depth)]).num_layers == depth
    for parse in (lambda a: EndoDAVOptions().parse(["--data_path", "/x", *a]),
                  lambda a: test_simple.parse_args(["--image_path", os.devnull, *a])):
        with pytest.raises(SystemExit):
            parse(["--num_layers", "20"])
