"""Port parity of the single-frame depth models on the CPU against the JAX
package: EndoDAC at vits and vitb (full widths, 12 blocks, image 28x28)
with ``use_bn``, ``use_cls_token``, ``pre_norm`` and ``conv_head`` on and
off, its ``--merge_lora`` serving graph with EndoDAC's alpha, a bf16
EndoDAC at JAX's init weights, `AFSfMDepth` with its BatchNorm statistics,
and the A/B switches of the JAX engine (``ENDODAV_LOWRES_OUTCONV``,
``ENDODAV_NO_FLASH``, ``ENDODAV_NO_FUSED``, ``ENDODAV_FUSED_TRAIN``,
``ENDODAV_NO_WARP_MM``), each switched port module against JAX's switched
one and its route checked.  Weights and inputs come from numpy seeds and
are carried across by `utils/convert.py:from_jax_params`."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.models.endodac import EndoDAC
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TOL = 1e-5      # disparities at f32
TAP_TOL = 1e-4  # ViT taps at f32
KEY = jax.random.PRNGKey(0)


def _fan_in(shapes, seed):
    """Numpy weights for a JAX variable tree of shapes: fan-in scaled
    kernels, small biases, scales near 1, positive BatchNorm variances."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if len(s.shape) > 1:
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        base = 1.0 if ("'scale'" in name or "gamma" in name) else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _endodac_variables(jm, x, seed):
    return _fan_in(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed)


def _port_sd(variables, kind):
    return from_jax_params(variables["params"], kind, variables.get("batch_stats"))


@contextlib.contextmanager
def pallas_interpret():
    """Every `pl.pallas_call` on Pallas's generic interpreter."""
    real = pl.pallas_call
    pl.pallas_call = lambda *a, **k: real(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        pl.pallas_call = real


FLAGS = {
    "on": dict(use_bn=True, use_cls_token=True, pre_norm=True, conv_head=True,
               residual_block_indexes=(2, 5, 8, 11)),
    "off": dict(use_bn=False, use_cls_token=False, pre_norm=False, conv_head=False),
}


@pytest.mark.parametrize("size,flags", [("vits", "on"), ("vits", "off"), ("vitb", "on"),
                                        ("vitb", "off")])
def test_endodac_matches_jax(size, flags):
    """All four disparity scales within 1e-5, the four ViT taps within 1e-4;
    5-D input flattened to frames."""
    from endodav_tpu.models.endodac import EndoDAC as JEndoDAC

    cfg = dict(image_shape=(28, 28), lora_type="dvlora", **FLAGS[flags])
    x = np.random.default_rng(1).uniform(0, 1, (1, 2, 32, 40, 3)).astype(np.float32)
    jm = JEndoDAC(backbone_size=size, **cfg)
    var = _endodac_variables(jm, x, seed=2)
    want, state = jax.jit(lambda v, a: jm.apply(
        v, a, capture_intermediates=lambda mdl, _: mdl.name == "pretrained",
        mutable=["intermediates"]))(var, jnp.asarray(x))
    want_taps = state["intermediates"]["pretrained"]["__call__"][0]

    tm = EndoDAC(size, **cfg).eval()
    tm.load_state_dict(_port_sd(var, "endodac"), strict=True)
    taps = []
    tm.pretrained.register_forward_hook(lambda mod, inp, out: taps.append(out))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for s in range(4):
        g, w = got[("disp", s)].numpy(), np.asarray(want[("disp", s)])
        assert g.shape == w.shape and g.shape[0] == 2
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"scale {s}")
    for (tok, cls), (jtok, jcls) in zip(taps[0], want_taps):
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=TAP_TOL, rtol=TAP_TOL)
        np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=TAP_TOL, rtol=TAP_TOL)


@pytest.mark.parametrize("lora_type", ["lora", "dvlora"])
def test_merge_lora_uses_endodac_alpha(lora_type, tmp_path, capsys):
    """`build_depth_model --model_type endodac --merge_lora` on a reference
    .pth carried from JAX weights serves what JAX's unmerged EndoDAC does:
    the merge uses EndoDAC's alpha (lora 1, dvlora r), not EndoDAV's."""
    from endodav_tpu.models.endodac import EndoDAC as JEndoDAC
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.options import EndoDAVOptions

    x = np.random.default_rng(3).uniform(0, 1, (2, 28, 28, 3)).astype(np.float32)
    jm = JEndoDAC(backbone_size="vits", image_shape=(28, 28), lora_type=lora_type, r=4)
    var = _endodac_variables(jm, x, seed=4)
    want = jax.jit(lambda v, a: jm.apply(v, a)[("disp", 0)])(var, jnp.asarray(x))
    torch.save(_port_sd(var, "endodac"), tmp_path / "depth_model.pth")
    opt = EndoDAVOptions().parse([
        "--no_cuda", "--model_type", "endodac", "--lora_type", lora_type,
        "--disable_residual_block", "--depth_image_shape", "28", "28", "--merge_lora",
        "--load_weights_folder", str(tmp_path)])
    model = engine.build_depth_model(opt)
    alpha = {"lora": 1.0, "dvlora": 4.0}[lora_type]
    assert f"alpha={alpha}" in capsys.readouterr().out
    assert model.lora_type == "none" and isinstance(model, EndoDAC)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))[("disp", 0)].numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_endodac_bf16_matches_jax():
    """bf16 EndoDAC (vits, the CLI's flags) at JAX's init weights: max 2.5e-2
    and mean 4e-3 against JAX's bf16 on ("disp", 0), the port's mean error
    against JAX's f32 at most 1.5x JAX's own, every scale in bf16."""
    from endodav_tpu.models.endodac import EndoDAC as JEndoDAC

    cfg = dict(backbone_size="vits", image_shape=(28, 42), lora_type="dvlora",
               residual_block_indexes=(2, 5, 8, 11))
    x = np.random.default_rng(5).uniform(0.05, 0.95, (2, 32, 48, 3)).astype(np.float32)
    params = jax.jit(JEndoDAC(**cfg).init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    run = lambda dt: jax.jit(lambda p, a: JEndoDAC(**cfg, dtype=dt).apply(  # noqa: E731
        {"params": p}, a))(params, jnp.asarray(x))
    w32, w16 = run(jnp.float32), run(jnp.bfloat16)
    tm = EndoDAC(**{k: v for k, v in cfg.items()}).eval()
    tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), "endodac"))
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


def test_afsfm_matches_jax():
    """AF-SfM (ResNet-18 + depth U-Net) with random BatchNorm statistics:
    four sigmoid scales within 1e-5."""
    from endodav_tpu.models.afsfm import AFSfMDepth as JAFSfM
    from endodav_tpu_torch.models.afsfm import AFSfMDepth

    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jm = JAFSfM()
    var = _fan_in(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed=7)
    want = jax.jit(lambda v, a: jm.apply(v, a))(var, jnp.asarray(x))
    tm = AFSfMDepth().eval()
    tm.load_state_dict(_port_sd(var, "afsfm"), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for s in range(4):
        g, w = got[("disp", s)].numpy(), np.asarray(want[("disp", s)])
        assert g.shape == w.shape == (2, 64 // 2 ** s, 96 // 2 ** s, 1)
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"scale {s}")


# ---------------------------------------------------------------- A/B switches


def _raises(*_a, **_k):
    raise AssertionError("the switched-off kernel route was taken")


def test_lowres_outconv_matches_jax(monkeypatch):
    """ENDODAV_LOWRES_OUTCONV: the non-temporal DPT head (EndoDAC's, BN and
    cls readout on) against JAX's under the switch, and against its own
    reference order (the 1x1 conv and the resize commute)."""
    from endodav_tpu.models.dpt import DPTDecoder as JDPT
    from endodav_tpu_torch.models.dpt import DPTDecoder

    cfg = dict(in_channels=64, features=32, out_channels=(16, 32, 64, 64), use_bn=True,
               use_clstoken=True)
    rng = np.random.default_rng(8)
    taps = [(rng.standard_normal((2, 20, 64)).astype(np.float32),
             rng.standard_normal((2, 64)).astype(np.float32)) for _ in range(4)]
    jtaps = [tuple(map(jnp.asarray, t)) for t in taps]
    jm = JDPT(temporal=False, **cfg)
    var = _fan_in(jax.eval_shape(lambda t: jm.init(KEY, t, (4, 5)), jtaps), seed=9)
    var = {"params": {"depth_head": var["params"]},
           "batch_stats": {"depth_head": var["batch_stats"]}}
    tm = DPTDecoder(temporal=False, **cfg).eval()
    sd = _port_sd(var, "endodac")
    tm.load_state_dict({k[len("depth_head."):]: v for k, v in sd.items()}, strict=True)
    ttaps = [tuple(map(torch.from_numpy, t)) for t in taps]
    with torch.inference_mode():
        ref = tm(ttaps, (4, 5))
    monkeypatch.setenv("ENDODAV_LOWRES_OUTCONV", "1")
    want = jax.jit(lambda v, t: jm.apply({"params": v["params"]["depth_head"],
                                          "batch_stats": v["batch_stats"]["depth_head"]},
                                         t, (4, 5)))(var, jtaps)
    with torch.inference_mode():
        got = tm(ttaps, (4, 5))
    for s in range(4):
        np.testing.assert_allclose(got[("disp", s)].numpy(), np.asarray(want[("disp", s)]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[("disp", s)].numpy(), ref[("disp", s)].numpy(),
                                   atol=TOL, rtol=TOL)


def test_no_flash_matches_jax(monkeypatch):
    """ENDODAV_NO_FLASH: the ViT attention takes the plain version (the flash
    wrapper is never called) and matches JAX's switched trunk; without the
    switch the wrapper is the route."""
    from endodav_tpu.models.vit import DinoViT as JViT
    from endodav_tpu_torch.models.vit import DinoViT
    from endodav_tpu_torch.ops import attention

    cfg = dict(embed_dim=64, depth=2, num_heads=4, lora_variant="lora", lora_alpha=1.0)
    x = np.random.default_rng(10).standard_normal((2, 28, 42, 3)).astype(np.float32)
    jm = JViT(**cfg)
    var = _fan_in(jax.eval_shape(lambda a: jm.init(KEY, a, (0, 1)), jnp.asarray(x)), 11)
    tm = DinoViT(**cfg)
    sd = from_jax_params({"pretrained": var["params"]})
    tm.load_state_dict({k[len("pretrained."):]: v for k, v in sd.items()}, strict=True)
    calls = []
    real = attention.qkv_attention
    monkeypatch.setattr(attention, "qkv_attention", lambda *a: calls.append(1) or real(*a))
    with torch.inference_mode():
        tm(torch.from_numpy(x), (0, 1))
    assert len(calls) == 2
    monkeypatch.setenv("ENDODAV_NO_FLASH", "1")
    monkeypatch.setattr(attention, "qkv_attention", _raises)
    want = jax.jit(lambda v, a: jm.apply(v, a, (0, 1)))(var, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), (0, 1))
    for (tok, cls), (jtok, jcls) in zip(got, want):
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=TAP_TOL, rtol=TAP_TOL)
        np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=TAP_TOL, rtol=TAP_TOL)


def _temporal_pair(seed):
    from endodav_tpu.models.motion import TemporalModule as JTemporal
    from endodav_tpu_torch.models.motion import TemporalModule

    frames = 4
    x = np.random.default_rng(seed).standard_normal((2 * frames, 3, 5, 64)).astype(np.float32)
    jm = JTemporal(in_channels=64, zero_initialize=False)
    var = _fan_in(jax.eval_shape(lambda a: jm.init(KEY, a, frames), jnp.asarray(x)), seed + 1)
    tm = TemporalModule(64)
    sd = from_jax_params({"head": {"motion_modules_0": var["params"]}})
    tm.load_state_dict({k[len("head.motion_modules.0."):]: v for k, v in sd.items()},
                       strict=True)
    return jm, var, tm, x, frames


def test_no_fused_matches_jax(monkeypatch):
    """ENDODAV_NO_FUSED: the serving motion module takes the unfused route
    (temporal attention, LayerNorm eps 1e-6; the fused block is never
    called) and matches JAX's switched module."""
    from endodav_tpu_torch.models import motion

    jm, var, tm, x, frames = _temporal_pair(12)
    monkeypatch.setenv("ENDODAV_NO_FUSED", "1")
    monkeypatch.setattr(motion, "fused_temporal_block", _raises)
    want = jax.jit(lambda v, a: jm.apply(v, a, frames))(var, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_fused_train_matches_jax(monkeypatch):
    """ENDODAV_FUSED_TRAIN: the training route takes the fused block (its
    LayerNorm eps 1e-5; temporal attention is never called) and matches
    JAX's switched train-mode module on its TPU route (the Pallas block in
    interpret mode), output and gradient of the input."""
    from endodav_tpu.models import motion as jmotion
    from endodav_tpu_torch.models import motion

    jm, var, tm, x, frames = _temporal_pair(14)
    monkeypatch.setenv("ENDODAV_FUSED_TRAIN", "1")
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    monkeypatch.setattr(motion, "temporal_attention", _raises)
    cot = np.random.default_rng(16).standard_normal(x.shape).astype(np.float32)
    with pallas_interpret():
        want, vjp = jax.vjp(lambda a: jm.apply(var, a, frames, train=True), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, frames, train=True)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-4, rtol=1e-4)


def test_no_warp_mm_matches_jax(monkeypatch):
    """ENDODAV_NO_WARP_MM: the bilinear warp (and its gradients) and the
    forward splat take the plain versions (the kernel wrappers are never
    called) and match JAX's switched ops."""
    from endodav_tpu.ops import sampling as jsampling
    from endodav_tpu_torch.ops import sampling

    rng = np.random.default_rng(17)
    img = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 16, 2)) * 2).astype(np.float32)
    coords = (rng.uniform(-1, 17, (2, 12, 16, 2))).astype(np.float32)
    monkeypatch.setenv("ENDODAV_NO_WARP_MM", "1")
    monkeypatch.setattr(sampling, "grid_sample_mm", _raises)
    monkeypatch.setattr(sampling, "splat_mm", _raises)

    def jloss(i, f):
        return (jsampling.flow_warp(i, f) ** 2).sum()

    want = jsampling.flow_warp(jnp.asarray(img), jnp.asarray(flow))
    want_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    want_occ = jsampling.forward_splat_occupancy(jnp.asarray(coords), 12, 16)
    ti, tf = (torch.from_numpy(a).requires_grad_() for a in (img, flow))
    got = sampling.flow_warp(ti, tf)
    gi, gf = torch.autograd.grad((got ** 2).sum(), (ti, tf))
    occ = sampling.forward_splat_occupancy(torch.from_numpy(coords), 12, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gi.numpy(), np.asarray(want_g[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gf.numpy(), np.asarray(want_g[1]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(occ.numpy(), np.asarray(want_occ), atol=TOL, rtol=TOL)


def test_serve_line_names_the_switches(monkeypatch, capsys):
    """`depth_window_forward` prints JAX's ``[serve] forward:`` line with the
    model type and the switches set, and gives a single-frame model's batch
    forward (no dedup)."""
    from endodav_tpu_torch.eval import engine

    monkeypatch.setenv("ENDODAV_NO_FLASH", "1")
    monkeypatch.setenv("ENDODAV_LOWRES_OUTCONV", "1")
    model = engine.init_random_(EndoDAC("vits", image_shape=(28, 28)), 0).eval()
    fwd = engine.depth_window_forward(model)
    assert ("[serve] forward: model_type=endodac env=ENDODAV_NO_FLASH+ENDODAV_LOWRES_OUTCONV"
            in capsys.readouterr().out)
    assert fwd.dedup is None and fwd.model is model
    out = fwd(torch.rand(3, 28, 28, 3))
    assert out.shape == (3, 32, 32, 1)
