"""Port parity: the model modules of the serving path against the JAX
package at narrow widths on the CPU.  Weights are drawn with numpy, set
on the JAX side and carried over by `utils/convert.py:from_jax_params`.
The JAX motion modules run their fused Pallas block in interpret mode,
which is the function the TPU serves (LayerNorm eps 1e-5 in the
attention sub-block)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.models.lora import LoRADense, merge_lora_params
from endodav_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)


def _randomize(params, seed, scale=0.2):
    """Every leaf of a JAX param tree replaced by seeded normal noise."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [(rng.standard_normal(np.shape(a)) * scale).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _state_dict(params, wrap, strip):
    """from_jax_params on a subtree placed at `wrap`, with `strip` removed
    from the front of every key."""
    tree = params
    for key in reversed(wrap):
        tree = {key: tree}
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    assert all(k.startswith(strip) for k in sd)
    return {k[len(strip):]: v for k, v in sd.items()}


# "dash2": dash in its phase 2 (the lora_index term on the top singular
# directions); phase 1 is "dash"
DENSE_CASES = ["none", "lora", "dvlora", "ssb", "dash", "dash2", "galora", "flora"]


def _variant(case):
    return ("dash", True) if case == "dash2" else (case, False)


@pytest.mark.parametrize("variant", DENSE_CASES)
def test_lora_dense_matches_jax(variant):
    from endodav_tpu.models.lora import LoRADense as JLoRADense
    from endodav_tpu_torch.models.lora import set_dash_phase2

    variant, phase2 = _variant(variant)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    jm = JLoRADense(7, r=4, lora_alpha=4.0, variant=variant)
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), phase2))
    tm = LoRADense(12, 7, r=4, lora_alpha=4.0, variant=variant)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items() if k != "kernel"}
    sd["weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
    tm.load_state_dict(sd, strict=True)
    set_dash_phase2(tm, phase2)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("variant", [c for c in DENSE_CASES if c != "none"])
def test_merge_lora_params_matches_jax_and_forward(variant):
    """The merge against JAX's and the merged layer against the adapted
    one; galora's input-gated delta raises in both packages."""
    from endodav_tpu.models.lora import merge_lora_params as jmerge
    from endodav_tpu_torch.models.lora import set_dash_phase2

    variant, phase2 = _variant(variant)
    torch.manual_seed(0)
    tm = LoRADense(12, 7, r=4, lora_alpha=4.0, variant=variant)
    with torch.no_grad():
        for prm in tm.parameters():
            prm.normal_(0, 0.3)
    set_dash_phase2(tm, phase2)
    sd = {f"fc.{k}": v for k, v in tm.state_dict().items()}
    jtree = {"fc": {("kernel" if k == "weight" else k):
                    (v.numpy().T if k == "weight" else v.numpy()) for k, v in tm.state_dict().items()}}
    if variant == "galora":
        with pytest.raises(ValueError, match="galora"):
            merge_lora_params(sd, variant, 4, 4.0)
        with pytest.raises(ValueError, match="galora"):
            jmerge(jtree, variant, 4, 4.0)
        return
    merged = merge_lora_params(sd, variant, 4, 4.0, dash_phase2=phase2)
    assert set(merged) == {"fc.weight", "fc.bias"}
    want = np.asarray(jmerge(jtree, variant, 4, 4.0, dash_phase2=phase2)["fc"]["kernel"]).T
    np.testing.assert_allclose(merged["fc.weight"].numpy(), want, atol=1e-6)
    plain = LoRADense(12, 7, variant="none")
    plain.load_state_dict({k[3:]: v for k, v in merged.items()}, strict=True)
    x = torch.randn(4, 12)
    np.testing.assert_allclose(plain(x).detach().numpy(), tm(x).detach().numpy(), atol=1e-5)


def test_dino_vit_matches_jax():
    from endodav_tpu.models.vit import DinoViT as JViT
    from endodav_tpu_torch.models.vit import DinoViT

    cfg = dict(embed_dim=64, depth=3, num_heads=4, residual_block_indexes=(1,),
               lora_variant="dvlora", lora_rank=4, lora_alpha=4.0)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 28, 42, 3)).astype(np.float32)
    jm = JViT(**cfg)
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(images), (0, 2))["params"], 4)
    want = jm.apply({"params": p}, jnp.asarray(images), (0, 2))
    tm = DinoViT(**cfg)
    tm.load_state_dict(_state_dict(p, ("pretrained",), "pretrained."), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(images), (0, 2))
    assert len(got) == len(want) == 2
    for (tok, cls), (jtok, jcls) in zip(got, want):
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=1e-4, rtol=1e-4)


def test_temporal_module_matches_jax_fused_interpret():
    from endodav_tpu.models.motion import TemporalModule as JTemporal
    from endodav_tpu_torch.models.motion import TemporalModule

    rng = np.random.default_rng(7)
    frames = 4
    x = rng.standard_normal((2 * frames, 3, 5, 64)).astype(np.float32)
    jm = JTemporal(in_channels=64, zero_initialize=False, fused=True, lora_variant="dvlora",
                   lora_alpha=4.0)
    with pltpu.force_tpu_interpret_mode():
        p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), frames)["params"]
    p = _randomize(p, 8, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), frames))
    tm = TemporalModule(64, lora_variant="dvlora", lora_alpha=4.0)
    sd = _state_dict(p, ("head", "motion_modules_0"), "head.motion_modules.0.")
    tm.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), frames).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("conv_head", [True, False])
def test_dpt_decoder_matches_jax(conv_head, monkeypatch):
    from endodav_tpu.models import motion as jmotion
    from endodav_tpu.models.dpt import DPTDecoder as JDPT
    from endodav_tpu_torch.models.dpt import DPTDecoder

    # the TPU serving route: every motion module through the fused block
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    cfg = dict(in_channels=64, features=32, out_channels=(16, 32, 64, 64), num_frames=32,
               conv_head=conv_head, out_sigmoid=not conv_head)
    ph, pw, frames = 4, 5, 2
    rng = np.random.default_rng(9)
    taps = [(rng.standard_normal((frames, ph * pw, 64)).astype(np.float32),
             rng.standard_normal((frames, 64)).astype(np.float32)) for _ in range(4)]
    jtaps = [(jnp.asarray(a), jnp.asarray(b)) for a, b in taps]
    jm = JDPT(temporal=True, **cfg)
    with pltpu.force_tpu_interpret_mode():
        p = _randomize(jm.init(jax.random.PRNGKey(0), jtaps, (ph, pw), frames)["params"], 10,
                       scale=0.1)
        want = jm.apply({"params": p}, jtaps, (ph, pw), frames)
    tm = DPTDecoder(**cfg)
    tm.load_state_dict(_state_dict(p, ("head",), "head."), strict=True)
    with torch.inference_mode():
        got = tm([(torch.from_numpy(a), torch.from_numpy(b)) for a, b in taps], (ph, pw), frames)
    for s in range(4):
        np.testing.assert_allclose(got[("disp", s)].numpy(), np.asarray(want[("disp", s)]),
                                   atol=1e-5, rtol=1e-5)
