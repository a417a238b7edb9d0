"""bf16 serving of the port against the JAX package on the CPU.

The port's modules built with ``dtype=torch.bfloat16`` against JAX's with
``dtype=jnp.bfloat16``, on the same numpy-seeded inputs and weights
(carried across by `utils/convert.py:from_jax_params`): `resize2d`,
`int8_dense` with its row scales, `LoRADense` (none/lora/dvlora), a
narrow `DinoViT` (plain, the fused-MLP route and the int8 projections),
`TemporalModule` on the fused route (JAX's Pallas block in interpret
mode), the unfused route and RoPE, and `DPTDecoder` (plain, and the
fused-RCU route with JAX told it runs on a TPU); then the whole flagship
`EndoDAV` at 56x70, T=2.  Each test also holds the output dtype of every
stage to JAX's.

Tolerances.  Two bf16 computations that round at different points differ
by a few bf16 ulps (2^-8 of the value) at each stage, so the modules are
held to a share of their output's scale (`_close`): the largest
difference to a share of the largest |output| and the mean one to a share
of the mean |output|, stated in each test: about twice the error measured
on the CPU, or one bf16 rounding (2^-8) where the two agree exactly.

The whole model runs at JAX's own init weights, where its disparity stays
in 0.29-0.83: with every weight random its sigmoids reach 0 and 1 and
bf16 rounding moves whole pixels, so JAX's own bf16 error against its f32
grows several-fold (`tools/bf16_reference_error.py` measures it at each
kind of weights).  At init weights the disparity is held to 2.5e-2 max
and 4e-3 mean against JAX bf16 (measured 7.8e-3 and 1.2e-3), and the
port's mean error against JAX f32 to 1.5x JAX's own bf16 mean error
against JAX f32 (measured 1.6e-3 against 1.9e-3).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from endodav_tpu_torch.models.endodav import EndoDAV
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

BF16 = torch.bfloat16


@contextlib.contextmanager
def pallas_interpret():
    """Every `pl.pallas_call` of the JAX kernels on Pallas's generic
    interpreter (`interpret=True`: the kernel body as plain JAX ops)."""
    real = pl.pallas_call
    pl.pallas_call = lambda *a, **k: real(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        pl.pallas_call = real


class _TpuBackendJax:
    """`jax` as a JAX module sees it on a TPU: `default_backend()` says
    "tpu", everything else is jax itself."""

    def __getattr__(self, name):
        return (lambda: "tpu") if name == "default_backend" else getattr(jax, name)


def _np(a):
    """A JAX or torch array as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _close(got, want, tol_max, tol_mean):
    """Same dtype as JAX's; the largest difference within ``tol_max`` of the
    largest |want| and the mean one within ``tol_mean`` of the mean |want|."""
    assert _dtype_name(got) == _dtype_name(want), (got.dtype, want.dtype)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    d = np.abs(g - w)
    assert np.all(np.isfinite(g))
    assert d.max() <= tol_max * np.abs(w).max(), (d.max(), np.abs(w).max())
    assert d.mean() <= tol_mean * np.abs(w).mean(), (d.mean(), np.abs(w).mean())


def _randomize(params, seed, scale=0.2):
    """Every leaf of a JAX param tree replaced by seeded normal noise."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * scale).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _fan_in(params, seed):
    """Fan-in scaled kernels, small biases, norm scales near 1: activations
    of order 1 through a head."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * (np.prod(np.shape(a)[:-1]) ** -0.5
                                                   if np.ndim(a) > 1 else 0.05)
               + (1.0 if np.ndim(a) == 1 and np.all(np.asarray(a) == 1) else 0.0))
              .astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _state_dict(params, wrap, strip):
    """from_jax_params on a subtree placed at `wrap`, with `strip` removed
    from the front of every key."""
    tree = params
    for key in reversed(wrap):
        tree = {key: tree}
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    return {k[len(strip):]: v for k, v in sd.items()}


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("shape,size,method,ac", [
    ((2, 9, 11, 16), (19, 23), "bilinear", True),   # the head's upsamples
    ((3, 12, 14, 1), (37, 29), "bilinear", True),   # disparity to the source size
    ((2, 10, 12, 8), (16, 20), "bicubic", False),
])
def test_resize2d_bf16_matches_jax(shape, size, method, ac):
    """bf16 matrices, bf16 products, the output in x's dtype (JAX
    ops/resize.py:166-199); within one bf16 rounding, 4e-3 of the largest
    |output| and 1e-3 in the mean (measured: equal)."""
    from endodav_tpu.ops.resize import resize2d as jresize
    from endodav_tpu_torch.ops.resize import resize2d

    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = jresize(jnp.asarray(x, jnp.bfloat16), size, method, align_corners=ac)
    got = resize2d(torch.from_numpy(x).to(BF16), size, method, align_corners=ac)
    _close(got, want, 4e-3, 1e-3)


def test_int8_dense_bf16_matches_jax():
    """bf16 activations: the row scales equal JAX's (the bf16 values are
    exact in f32), the int8 codes too, and the f32 epilogue cast to
    ``out_dtype`` (JAX ops/quant.py:102-127) agrees to one bf16 rounding,
    4e-3 of the largest |output| and 1e-3 in the mean (measured: equal)."""
    from endodav_tpu.ops.quant import _quantize_rows, int8_dense as jint8
    from endodav_tpu_torch.ops.quant import int8_dense, quantize_rows

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)  # JAX [in, out]
    b = rng.standard_normal(48).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(BF16)
    j8, jscale = _quantize_rows(xj)
    t8, tscale = quantize_rows(xt)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    wt = torch.from_numpy(w.T.copy())
    for out_dtype, jdt in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        want = jint8(xj, jnp.asarray(w), jnp.asarray(b), out_dtype=jdt)
        got = int8_dense(xt, wt, torch.from_numpy(b), out_dtype=out_dtype)
        _close(got, want, 4e-3, 1e-3)
    assert int8_dense(xt, wt).dtype == BF16  # default: x's dtype


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("variant", ["none", "lora", "dvlora", "ssb", "dash", "galora", "flora"])
def test_lora_dense_bf16_matches_jax(variant):
    """The adapter factors formed in f32 and cast (JAX models/lora.py:
    126-141); within 1e-2 of the largest |output|, 3e-3 in the mean
    (measured 4.4e-3 and 1.5e-3)."""
    from endodav_tpu.models.lora import LoRADense as JLoRADense
    from endodav_tpu_torch.models.lora import LoRADense

    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jm = JLoRADense(24, r=4, lora_alpha=4.0, variant=variant, dtype=jnp.bfloat16)
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    for xdt, tdt in ((jnp.bfloat16, BF16), (jnp.float32, torch.float32)):
        want = jm.apply({"params": p}, jnp.asarray(x, xdt))
        tm = LoRADense(32, 24, r=4, lora_alpha=4.0, variant=variant, dtype=BF16)
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items() if k != "kernel"}
        sd["weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
        tm.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            got = tm(torch.from_numpy(x).to(tdt))
        # "none" and "ssb" return the compute dtype, the other variants x's
        # dtype
        _close(got, want, 1e-2, 3e-3)


def _jax_dtypes(inter, stages):
    """Output dtypes of the JAX modules at the flax paths ``stages.values()``
    of captured intermediates, keyed by ``stages``' keys."""
    out = {}
    for name, path in stages.items():
        node = inter
        for key in path:
            node = node[key]
        out[name] = _dtype_name(node["__call__"][0])
    return out


@contextlib.contextmanager
def _port_dtypes(model, names):
    """Output dtypes of the port's submodules ``names`` during the block,
    recorded by forward hooks into the dict it yields."""
    seen = {}
    hooks = [model.get_submodule(n).register_forward_hook(
        lambda m, a, out, n=n: seen.__setitem__(n, _dtype_name(out))) for n in names]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


VIT_CFG = dict(embed_dim=128, depth=3, num_heads=2, residual_block_indexes=(1,), lora_rank=4,
               lora_alpha=4.0)
# every block, its attention, MLP, LayerScales and residual branch
VIT_STAGES = {f"blocks.{i}" + (f".{sub}" if sub else ""):
              (f"blocks_{i}",) + ((sub,) if sub else ())
              for i in range(3) for sub in ("", "attn", "mlp", "ls1", "ls2")
              + (("residual_",) if i == 1 else ())}


@pytest.mark.parametrize("route", ["plain", "fused_mlp", "int8"])
def test_dino_vit_bf16_matches_jax(route, monkeypatch):
    """A 3-block ViT at width 128 with a residual block: dvlora on the plain
    route; the merged MLP on the fused-MLP kernel (JAX told it runs on a
    TPU, its kernel in interpret mode); the int8 projections.  The taps
    within 2e-2 of their largest |value|, 5e-3 in the mean (measured at
    most 9.4e-3 and 2.5e-3, int8)."""
    from endodav_tpu.models import vit as jvit
    from endodav_tpu_torch.models import vit as tvit

    cfg = dict(VIT_CFG, lora_variant="dvlora" if route == "plain" else "none")
    monkeypatch.setenv("ENDODAV_FUSED_MLP", "1" if route == "fused_mlp" else "0")
    monkeypatch.delenv("ENDODAV_INT8", raising=False)
    calls = []
    if route == "fused_mlp":
        monkeypatch.setattr(jvit, "jax", _TpuBackendJax())
        real = tvit.fused_mlp
        monkeypatch.setattr(tvit, "fused_mlp", lambda *a: calls.append(a[0].dtype) or real(*a))
    quant = route == "int8"
    images = jnp.asarray(np.random.default_rng(3).standard_normal((2, 28, 42, 3)), jnp.float32)
    jm = jvit.DinoViT(**cfg, dtype=jnp.bfloat16, quant_int8=quant)
    with pallas_interpret():
        p = jax.jit(lambda k: jm.init(k, images, (0, 2)))(jax.random.PRNGKey(0))["params"]
        p = _randomize(p, 4, scale=0.1)
        want, state = jax.jit(lambda p: jm.apply({"params": p}, images, (0, 2),
                                                 capture_intermediates=True,
                                                 mutable=["intermediates"]))(p)
    tm = tvit.DinoViT(**cfg, dtype=BF16)
    tm.load_state_dict(_state_dict(p, ("pretrained",), "pretrained."), strict=True)
    with torch.inference_mode(), _port_dtypes(tm, VIT_STAGES) as got_dt:
        got = tm(torch.from_numpy(np.array(images)), (0, 2), quant_int8=quant)
    assert got_dt == _jax_dtypes(state["intermediates"], VIT_STAGES)
    assert calls == ([BF16] * 3 if route == "fused_mlp" else [])
    for (tok, cls), (jtok, jcls) in zip(got, want):
        _close(tok, jtok, 2e-2, 5e-3)
        _close(cls, jcls, 2e-2, 5e-3)


@pytest.mark.parametrize("route,scale", [
    ("fused", 1.0), ("unfused", 1.0), ("rope", 1.0),
    # proj_in at 3e-3: the sub-blocks' LayerNorms see rows whose variance is
    # of the order of their eps, 1e-5 on the fused route, 1e-6 unfused
    ("fused", 3e-3), ("unfused", 3e-3)])
def test_temporal_module_bf16_matches_jax(route, scale):
    """`TemporalModule` at C=64, T=4: the fused route (JAX's Pallas block in
    interpret mode, the port's plain version, LayerNorm eps 1e-5), the
    unfused route (the port's train route, eps 1e-6) and RoPE; within 2e-2
    of the largest |output|, 1.3e-2 in the mean (measured at most 8.8e-3
    and 6.6e-3, under two bf16 roundings of outputs of order 1).  At the
    small proj_in the two routes differ by over 0.25 of the largest
    |output|, so each eps is pinned."""
    from endodav_tpu.models.motion import TemporalModule as JTemporal
    from endodav_tpu_torch.models.motion import TemporalModule

    rng = np.random.default_rng(7)
    frames = 4
    x = rng.standard_normal((2 * frames, 3, 5, 64)).astype(np.float32)
    pos = "rope" if route == "rope" else "ape"
    kw = dict(in_channels=64, zero_initialize=False, lora_variant="dvlora", lora_alpha=4.0,
              pos_embedding_type=pos)
    jms = {f: JTemporal(**kw, fused=f, dtype=jnp.bfloat16) for f in (True, False)}
    p = jax.jit(lambda k: jms[False].init(k, jnp.asarray(x), frames))(jax.random.PRNGKey(0))
    p = _fan_in(p["params"], 8)
    p["proj_in"] = jax.tree_util.tree_map(lambda a: a * scale, p["proj_in"])
    xj = jnp.asarray(x, jnp.bfloat16)
    with pallas_interpret():
        want = {f: jax.jit(lambda p, jm=jm: jm.apply({"params": p}, xj, frames))(p)
                for f, jm in jms.items()}
    tm = TemporalModule(64, lora_variant="dvlora", lora_alpha=4.0, pos_embedding_type=pos,
                        dtype=BF16)
    tm.load_state_dict(_state_dict(p, ("head", "motion_modules_0"), "head.motion_modules.0."),
                       strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).to(BF16), frames, train=route == "unfused")
    jwant = want[route == "fused"]
    _close(got, jwant, 2e-2, 1.3e-2)
    if scale < 1:
        other = _np(want[route != "fused"])
        assert np.abs(other - _np(jwant)).max() > 5 * 2e-2 * np.abs(_np(jwant)).max()


@pytest.mark.parametrize("fused_rcu", [False, True])
def test_dpt_decoder_bf16_matches_jax(fused_rcu, monkeypatch):
    """The vits-width head (features 64, out_channels 48/96/192/384) on the
    serving route: the motion modules on the fused block, and with
    ``ENDODAV_FUSED_RCU=1`` every RCU on JAX's Pallas kernel (interpret
    mode) and the port's plain version.  The disparity within 1e-1 of its
    largest value, 2e-2 in the mean (measured at most 4.7e-2 and 1.1e-2:
    at these fan-in scaled random weights the head's convolutions and
    motion modules compound the roundings); every stage's dtype as
    JAX's."""
    from endodav_tpu.models import dpt as jdpt
    from endodav_tpu.models import motion as jmotion
    from endodav_tpu_torch.models.dpt import DPTDecoder

    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    monkeypatch.setenv("ENDODAV_FUSED_RCU", "1" if fused_rcu else "0")
    if fused_rcu:
        monkeypatch.setattr(jdpt, "jax", _TpuBackendJax())
    cfg = dict(in_channels=384, features=64, out_channels=(48, 96, 192, 384), num_frames=32)
    ph, pw, frames = 4, 5, 2
    rng = np.random.default_rng(9)
    taps = [(rng.standard_normal((frames, ph * pw, 384)).astype(np.float32),
             rng.standard_normal((frames, 384)).astype(np.float32)) for _ in range(4)]
    jtaps = [(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)) for a, b in taps]
    jm = jdpt.DPTDecoder(temporal=True, dtype=jnp.bfloat16, **cfg)
    with pallas_interpret():
        params = jax.jit(lambda k: jm.init(k, jtaps, (ph, pw), frames))(jax.random.PRNGKey(0))
        params = _fan_in(params["params"], 10)
        want, state = jax.jit(lambda p: jm.apply({"params": p}, jtaps, (ph, pw), frames,
                                                 capture_intermediates=True,
                                                 mutable=["intermediates"]))(params)
    tm = DPTDecoder(**cfg, dtype=BF16)
    sd = from_jax_params({"head": jax.tree_util.tree_map(np.asarray, params)})
    tm.load_state_dict({k[len("head."):]: v for k, v in sd.items()}, strict=True)
    stages = {**{f"motion_modules.{i}": (f"motion_modules_{i}",) for i in range(4)},
              **{f"scratch.refinenet{i}": (f"refinenet{i}",) for i in range(1, 5)},
              **{f"conv_depth_{i}": (f"conv_depth_{i}",) for i in range(1, 5)}}
    calls = []
    if fused_rcu:
        from endodav_tpu_torch.models import dpt as tdpt

        real = tdpt.fused_rcu
        monkeypatch.setattr(tdpt, "fused_rcu", lambda x, c1, c2: calls.append(x.dtype)
                            or real(x, c1, c2))
    with torch.inference_mode(), _port_dtypes(tm, stages) as got_dt:
        got = tm([(torch.from_numpy(a).to(BF16), torch.from_numpy(b).to(BF16))
                  for a, b in taps], (ph, pw), frames)
    assert got_dt == _jax_dtypes(state["intermediates"], stages)
    assert calls == ([BF16] * 7 if fused_rcu else [])
    for s in range(4):
        _close(got[("disp", s)], want[("disp", s)], 1e-1, 2e-2)


# ---------------------------------------------------------------- the whole model

FLAGSHIP = dict(encoder="vits", lora_type="dvlora", residual_block_indexes=(2, 5, 8, 11),
                temporal_lora=True)

# JAX flax paths and the port's module names of the stages held by dtype
WHOLE_STAGES = {
    **{f"pretrained.blocks.{i}": ("pretrained", f"blocks_{i}") for i in range(12)},
    **{f"head.motion_modules.{i}": ("head", f"motion_modules_{i}") for i in range(4)},
    **{f"head.scratch.refinenet{i}": ("head", f"refinenet{i}") for i in range(1, 5)},
    **{f"head.conv_depth_{i}": ("head", f"conv_depth_{i}") for i in range(1, 5)},
}


@pytest.fixture(scope="module")
def flagship():
    """JAX's flagship EndoDAV (56x70) at its init weights, its f32 and bf16
    forwards on its TPU route (the fused temporal block in interpret mode),
    the bf16 intermediates' dtypes, and the port's bf16 model on the same
    weights."""
    from endodav_tpu.models import motion as jmotion
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    real = jmotion._use_fused_block
    jmotion._use_fused_block = lambda pos, dim: pos == "ape"
    try:
        jm = JEndoDAV(image_shape=(56, 70), **FLAGSHIP)
        jb = JEndoDAV(image_shape=(56, 70), dtype=jnp.bfloat16, **FLAGSHIP)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 56, 70, 3)))["params"]
        video = np.random.default_rng(7).uniform(0.05, 0.95, (1, 2, 64, 80, 3)).astype(np.float32)
        with pallas_interpret():
            want32 = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(video))
            want16, state = jax.jit(lambda p, x: jb.apply(
                {"params": p}, x, capture_intermediates=True, mutable=["intermediates"]))(
                    params, jnp.asarray(video))
    finally:
        jmotion._use_fused_block = real
    dtypes = _jax_dtypes(state["intermediates"], WHOLE_STAGES)
    model = EndoDAV(image_shape=(56, 70), **FLAGSHIP)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return dict(video=video, want32=want32, want16=want16, dtypes=dtypes,
                model=model.eval().clone(dtype=BF16))


def test_endodav_bf16_matches_jax(flagship):
    """Port bf16 against JAX bf16 on ("disp", 0): max 2.5e-2, mean 4e-3;
    the port's bf16 mean error against JAX f32 at most 1.5x JAX's own; every
    scale's dtype and every stage's (12 blocks, 4 motion modules, 4 fusion
    blocks, 4 heads) as JAX's."""
    model = flagship["model"]
    with torch.inference_mode(), _port_dtypes(model, WHOLE_STAGES) as got_dt:
        got = model(torch.from_numpy(flagship["video"]))
    assert got_dt == flagship["dtypes"]
    assert set(got_dt.values()) == {"bfloat16"}
    for s in range(4):
        assert _dtype_name(got[("disp", s)]) == _dtype_name(flagship["want16"][("disp", s)])
        assert got[("disp", s)].shape == flagship["want16"][("disp", s)].shape
    g = _np(got[("disp", 0)])
    w16, w32 = _np(flagship["want16"][("disp", 0)]), _np(flagship["want32"][("disp", 0)])
    d = np.abs(g - w16)
    assert d.max() <= 2.5e-2 and d.mean() <= 4e-3, (d.max(), d.mean())
    own = np.abs(w16 - w32).mean()
    assert np.abs(g - w32).mean() <= 1.5 * own, (np.abs(g - w32).mean(), own)


def test_endodav_bf16_serving_stages_match_jax(flagship):
    """encode -> decode_prefix -> decode_suffix at bf16: the taps and the
    four prefix maps in bf16 (the dedup boundary keeps the model's dtype),
    the suffix equal to the whole forward."""
    model = flagship["model"]
    video = torch.from_numpy(flagship["video"])
    with torch.inference_mode():
        taps = model.encode(video)
        maps = model.decode_prefix(taps)
        out = model.decode_suffix(maps, 2)
        whole = model(video)
    assert {_dtype_name(t) for tap in taps for t in tap} == {"bfloat16"}
    assert {_dtype_name(m) for m in maps} == {"bfloat16"}
    assert model.preprocess(video).dtype == torch.float32  # in the input's dtype, as JAX
    for s in range(4):
        assert torch.equal(out[("disp", s)], whole[("disp", s)])


def test_clone_shares_the_parameters(flagship):
    """`EndoDAV.clone(dtype=...)` builds the model over the same parameter
    tensors; the f32 original is unchanged."""
    bf16 = flagship["model"]
    f32 = bf16.clone(dtype=torch.float32)
    assert f32.dtype == torch.float32 and bf16.dtype == BF16
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(f32.parameters(), bf16.parameters()))
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}
