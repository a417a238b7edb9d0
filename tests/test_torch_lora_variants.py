"""Port parity of the LoRA family's other modules on the CPU against the
JAX package (`endodav_tpu/models/lora.py`, `models/vit.py:SwiGLUFFN`):
`LoRAConv` (stride 1 and 2, "SAME" padding) and `LoRAEmbed` with their
merges, flora's scale rule, the SwiGLU FFN alone and in a ViT trunk with
``ffn_layer="swiglu"`` through the weight bridge, and `dash_svd_update`
on a Dash trunk; ``--lora_type``'s choices against JAX's, and the
engine's rules (ssb's seeded vectors near 1, ssb and Dash merged, galora
served unmerged).  Weights and inputs come from numpy seeds; all at 1e-5.

`dash_svd_update` is compared through ``u_top · diag(index) · vt_top``
(the phase-2 term itself) and not U and Vᵀ, whose singular vectors may
flip sign in pairs between two SVDs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu_torch.models.lora import (LoRAConv, LoRADense, LoRAEmbed, dash_svd_update,
                                           merge_lora_params)
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)

TOL = 1e-5
KEY = jax.random.PRNGKey(0)


def _randomize(params, seed, scale=0.2):
    """Every leaf of a JAX param tree replaced by seeded normal noise."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * scale).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _conv_sd(p):
    """The JAX LoRAConv params as the port's state dict."""
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    sd["weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"])
                                                         .transpose(3, 2, 0, 1)))
    del sd["kernel"]
    return sd


@pytest.mark.parametrize("stride,hw", [(1, (9, 11)), (2, (9, 11)), (2, (8, 12))])
def test_lora_conv_matches_jax(stride, hw):
    from endodav_tpu.models.lora import LoRAConv as JLoRAConv

    x = np.random.default_rng(1).standard_normal((2, *hw, 6)).astype(np.float32)
    jm = JLoRAConv(5, 3, r=2, lora_alpha=3.0, strides=stride)
    p = _randomize(jm.init(KEY, jnp.asarray(x))["params"], 2)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = LoRAConv(6, 5, 3, r=2, lora_alpha=3.0, stride=stride)
    tm.load_state_dict(_conv_sd(p), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_lora_conv_merge_matches_jax_and_forward():
    """A conv's delta folds with alpha 1 and the model-wide r, whatever the
    dense variant (JAX merge_lora_params :276-281)."""
    from endodav_tpu.models.lora import LoRAConv as JLoRAConv
    from endodav_tpu.models.lora import merge_lora_params as jmerge

    x = np.random.default_rng(3).standard_normal((2, 7, 9, 4)).astype(np.float32)
    jm = JLoRAConv(6, 3, r=2)
    p = _randomize(jm.init(KEY, jnp.asarray(x))["params"], 4)
    tm = LoRAConv(4, 6, 3, r=2)
    tm.load_state_dict(_conv_sd(p), strict=True)
    merged = merge_lora_params({f"conv.{k}": v for k, v in tm.state_dict().items()}, "lora", 2)
    assert set(merged) == {"conv.weight", "conv.bias"}
    want = np.asarray(jmerge({"conv": p}, "lora", 2)["conv"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(merged["conv.weight"].numpy(), want, atol=1e-6)
    plain = torch.nn.Conv2d(4, 6, 3, padding=1)
    plain.load_state_dict({k[5:]: v for k, v in merged.items()}, strict=True)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = plain(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), tm(xt).numpy(), atol=TOL, rtol=TOL)


def test_lora_embed_and_merge_match_jax():
    from endodav_tpu.models.lora import LoRAEmbed as JLoRAEmbed
    from endodav_tpu.models.lora import merge_lora_params as jmerge

    ids = np.random.default_rng(5).integers(0, 10, (3, 7))
    jm = JLoRAEmbed(10, 6, r=3, lora_alpha=2.0)
    p = _randomize(jm.init(KEY, jnp.asarray(ids))["params"], 6)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(ids)))
    tm = LoRAEmbed(10, 6, r=3, lora_alpha=2.0)
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    merged = merge_lora_params({f"emb.{k}": v for k, v in tm.state_dict().items()}, "lora", 3,
                               2.0)
    assert set(merged) == {"emb.embedding"}
    np.testing.assert_allclose(merged["emb.embedding"].numpy(),
                               np.asarray(jmerge({"emb": p}, "lora", 3, 2.0)["emb"]["embedding"]),
                               atol=1e-6)
    np.testing.assert_allclose(merged["emb.embedding"].numpy()[ids], want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("alpha", [None, 0.0, 3.0])
def test_flora_scale_matches_jax(alpha):
    """flora's scale (alpha if alpha > 0 else r) / (r + 1e-5), alpha None
    meaning 2r, in the layer and in the merge."""
    from endodav_tpu.models.lora import LoRADense as JLoRADense
    from endodav_tpu.models.lora import merge_lora_params as jmerge

    x = np.random.default_rng(7).standard_normal((4, 10)).astype(np.float32)
    jm = JLoRADense(6, r=3, lora_alpha=alpha, variant="flora")
    p = _randomize(jm.init(KEY, jnp.asarray(x))["params"], 8)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = LoRADense(10, 6, r=3, lora_alpha=alpha, variant="flora")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items() if k != "kernel"}
    sd["weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
    tm.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, atol=TOL, rtol=TOL)
    merged = merge_lora_params({f"fc.{k}": v for k, v in sd.items()}, "flora", 3, alpha)
    np.testing.assert_allclose(merged["fc.weight"].numpy(),
                               np.asarray(jmerge({"fc": p}, "flora", 3, alpha)["fc"]["kernel"]).T,
                               atol=1e-6)


def test_swiglu_ffn_matches_jax():
    from endodav_tpu.models.vit import SwiGLUFFN as JSwiGLU
    from endodav_tpu_torch.models.vit import SwiGLUFFN

    x = np.random.default_rng(9).standard_normal((2, 5, 24)).astype(np.float32)
    jm = JSwiGLU(96, 24)
    p = _randomize(jm.init(KEY, jnp.asarray(x))["params"], 10)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = SwiGLUFFN(24, 96)
    assert tm.w12.out_features == 2 * 64 and tm.w3.in_features == 64  # (int(64) + 7) // 8 * 8
    tm.load_state_dict({f"{n}.{'weight' if k == 'kernel' else k}":
                        torch.from_numpy(np.ascontiguousarray(np.asarray(v).T if k == "kernel"
                                                              else np.asarray(v)))
                        for n in ("w12", "w3") for k, v in p[n].items()}, strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_swiglu_vit_matches_jax():
    """A ViT trunk with ``ffn_layer="swiglu"`` through `from_jax_params`
    (the w12/w3 rules): every tap within 1e-5."""
    from endodav_tpu.models.vit import DinoViT as JViT
    from endodav_tpu_torch.models.vit import DinoViT

    cfg = dict(embed_dim=48, depth=2, num_heads=4, ffn_layer="swiglu", lora_variant="ssb")
    images = np.random.default_rng(11).standard_normal((2, 28, 42, 3)).astype(np.float32)
    jm = JViT(**cfg)
    p = _randomize(jm.init(KEY, jnp.asarray(images), (0, 1))["params"], 12, scale=0.1)
    want = jm.apply({"params": p}, jnp.asarray(images), (0, 1))
    tm = DinoViT(**cfg)
    sd = from_jax_params({"pretrained": jax.tree_util.tree_map(np.asarray, p)})
    tm.load_state_dict({k[len("pretrained."):]: v for k, v in sd.items()}, strict=True)
    assert "blocks.1.mlp.w12.weight" in tm.state_dict()
    with torch.inference_mode():
        got = tm(torch.from_numpy(images), (0, 1))
    for (tok, cls), (jtok, jcls) in zip(got, want):
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=TOL, rtol=TOL)


def test_dash_svd_update_matches_jax():
    """Every Dash layer of a two-block trunk (fc1 and fc2 of each) after the
    phase boundary: u_top · diag(index) · vt_top against JAX's, with a
    nonzero lora_B so that the change rates are distinct; the frozen and
    trained weights untouched; the phase-2 forward against JAX's."""
    from endodav_tpu.models.lora import dash_svd_update as jsvd
    from endodav_tpu.models.vit import DinoViT as JViT
    from endodav_tpu_torch.models.lora import set_dash_phase2
    from endodav_tpu_torch.models.vit import DinoViT

    cfg = dict(embed_dim=48, depth=2, num_heads=4, lora_variant="dash", lora_rank=4)
    images = np.random.default_rng(13).standard_normal((2, 28, 28, 3)).astype(np.float32)
    jm = JViT(**cfg)
    p = _randomize(jm.init(KEY, jnp.asarray(images), (1,))["params"], 14, scale=0.1)
    jp = jsvd(jax.tree_util.tree_map(np.asarray, p))
    tm = DinoViT(**cfg)
    sd = from_jax_params({"pretrained": jax.tree_util.tree_map(np.asarray, p)})
    tm.load_state_dict({k[len("pretrained."):]: v for k, v in sd.items()}, strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    dash_svd_update(tm)
    layers = [(i, fc) for i in range(2) for fc in ("fc1", "fc2")]
    for i, fc in layers:
        m = tm.blocks[i].mlp.get_submodule(fc)
        jl = jp[f"blocks_{i}"]["mlp"][fc]
        assert m.weight_u_top.shape == jl["weight_u_top"].shape
        idx = m.lora_index.detach().numpy()
        got = (m.weight_u_top.detach().numpy() * idx) @ m.weight_vt_top.detach().numpy()
        want = (np.asarray(jl["weight_u_top"]) * idx) @ np.asarray(jl["weight_vt_top"])
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    after = tm.state_dict()
    for k, v in before.items():
        if not k.endswith(("weight_u_top", "weight_vt_top")):
            assert torch.equal(after[k], v), k
    want = jm.apply({"params": jp}, jnp.asarray(images), (1,), True)
    with torch.inference_mode():
        got = set_dash_phase2(tm, True)(torch.from_numpy(images), (1,))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0][0]), atol=TOL, rtol=TOL)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown lora variant"):
        LoRADense(4, 4, variant="qlora")
    with pytest.raises(ValueError, match="unknown lora variant"):
        merge_lora_params({}, "qlora", 4)


# ---------------------------------------------------- options and engine


def _choices(parser, flag):
    return next(a.choices for a in parser._actions if flag in a.option_strings)


def test_lora_type_choices_are_jax_s():
    from endodav_tpu.options import EndoDAVOptions as JOptions
    from endodav_tpu_torch.options import EndoDAVOptions

    assert (list(_choices(EndoDAVOptions().parser, "--lora_type"))
            == list(_choices(JOptions().parser, "--lora_type"))
            == ["lora", "dvlora", "ssb", "dash", "none"])


def _engine_opt(*args):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse(["--no_cuda", "--depth_image_shape", "28", "42",
                                   "--disable_residual_block", *args])


def test_init_random_keeps_ssb_near_one_and_dash_live():
    """The engine's seeded weights: ssb's scale vectors 1 + 0.1 N(0, 1) (a
    fan-in rule would give [n, 1] vectors N(0, 1) and flip whole rows of
    the trunk), Dash's index and singular directions nonzero."""
    from endodav_tpu_torch.eval import engine

    sd = engine.build_depth_model(_engine_opt("--lora_type", "ssb", "--temporal_lora")).state_dict()
    vec = torch.cat([v.flatten() for k, v in sd.items() if k.endswith(("lora_A", "lora_B"))])
    assert vec.numel() > 10000 and abs(vec.mean().item() - 1) < 0.01
    assert abs(vec.std().item() - 0.1) < 0.01 and vec.min().item() > 0
    sd = engine.build_depth_model(_engine_opt("--lora_type", "dash")).state_dict()
    for leaf in ("lora_index", "weight_u_top", "weight_vt_top"):
        assert sd[f"pretrained.blocks.0.mlp.fc1.{leaf}"].abs().min() > 0, leaf


def test_build_depth_model_merges_ssb_and_dash_and_serves_galora_unmerged(capsys):
    """--merge_lora folds ssb and Dash (its phase 1, as a .pth serves) into
    a plain trunk that serves what the adapted one does; galora prints
    JAX's message and serves the adapted graph."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.models.lora import dash_phase2_of

    video = torch.from_numpy(np.random.default_rng(15).uniform(0, 1, (1, 2, 28, 42, 3))
                             .astype(np.float32))
    for variant in ("ssb", "dash"):
        built = engine.build_depth_model(_engine_opt("--lora_type", variant, "--temporal_lora"))
        assert not dash_phase2_of(built)
        merged = engine.build_depth_model(_engine_opt("--lora_type", variant, "--temporal_lora",
                                                      "--merge_lora"))
        assert merged.lora_type == "none" and not any("lora_" in k for k in merged.state_dict())
        with torch.inference_mode():
            a, b = built(video)[("disp", 0)], merged(video)[("disp", 0)]
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL)
    opt = _engine_opt("--merge_lora")
    opt.lora_type = "galora"  # no CLI choice, as in JAX
    model = engine.build_depth_model(opt)
    assert "--merge_lora ignored: galora" in capsys.readouterr().out
    assert model.lora_type == "galora"
