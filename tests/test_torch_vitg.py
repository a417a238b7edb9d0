"""``vitg`` (DINOv2 giant: 1536 wide, 40 blocks, 24 heads of 64) in the port
against the JAX package on the CPU, and the fused MLP's widths.

No option selects vitg in either package (``--encoder`` is vits|vitb|vitl);
it is reached from Python as ``DinoViT(**VIT_CONFIGS["vitg"])``.  The
trunk is held against JAX's at vitg's widths with its depth cut to 2
blocks (40 blocks of 1536 take 4.4 GB of f32 weights a package), with
the MLP on its plain route and through `fused_mlp` (``ENDODAV_FUSED_MLP=1``
on the unadapted trunk, whose plain version the CPU runs); the fused MLP
alone at vitg's widths against JAX's `mlp_reference` and its Pallas kernel
in interpret mode; and the widths the CUDA kernel takes (`mlp_config`, which
runs without a card).

Tolerances: the trunk's tokens within 1e-4 of max(1, their largest) (f32
sums over 1536-wide products reassociate, as `tests/test_torch_port_models.
test_dino_vit_matches_jax`); the MLP within 1e-5 of JAX's `mlp_reference`
(exact gelu both) and 1e-4 of its Pallas kernel (erf by Abramowitz-Stegun,
|error| <= 1.5e-7), as `tests/test_torch_vitl_kernels.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_endodac import KEY, _fan_in
from test_torch_port_models import _state_dict

from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_config

torch.set_num_threads(1)

TOKEN_TOL, REF_TOL, KERNEL_TOL = 1e-4, 1e-5, 1e-4


def test_vit_configs_match_jax():
    from endodav_tpu.models.vit import VIT_CONFIGS as JCONFIGS
    from endodav_tpu_torch.models.vit import VIT_CONFIGS

    assert VIT_CONFIGS == JCONFIGS
    assert VIT_CONFIGS["vitg"] == dict(embed_dim=1536, depth=40, num_heads=24)


@pytest.mark.parametrize("fused", [False, True])
def test_vitg_width_trunk_matches_jax(fused, monkeypatch):
    """vitg's widths and heads at 2 blocks, taps after both, on two 28x42
    frames (6 patches and the cls token)."""
    from endodav_tpu.models.vit import DinoViT as JViT
    from endodav_tpu_torch.kernels import fused_mlp as fm
    from endodav_tpu_torch.models import vit as vit_mod
    from endodav_tpu_torch.models.vit import VIT_CONFIGS, DinoViT

    monkeypatch.delenv("ENDODAV_FUSED_MLP", raising=False)
    monkeypatch.delenv("ENDODAV_INT8", raising=False)
    cfg = dict(VIT_CONFIGS["vitg"], depth=2)
    images = np.random.default_rng(40).uniform(-1, 1, (2, 28, 42, 3)).astype(np.float32)
    jm = JViT(**cfg)
    params = _fan_in(jax.eval_shape(lambda k, x: jm.init(k, x, (0, 1)), KEY, jnp.asarray(images)),
                     seed=41)["params"]
    want = jm.apply({"params": params}, jnp.asarray(images), (0, 1))
    tm = DinoViT(**cfg, ffn_layer="mlp")
    tm.load_state_dict(_state_dict(params, ("pretrained",), "pretrained."), strict=True)
    calls = []
    if fused:
        monkeypatch.setenv("ENDODAV_FUSED_MLP", "1")
        monkeypatch.setattr(vit_mod, "fused_mlp", lambda *a: calls.append(
            (a[1].shape, a[3].shape)) or fm.fused_mlp(*a))
    with torch.inference_mode():
        got = tm(torch.from_numpy(images), (0, 1))
    assert calls == ([((1536, 6144), (6144, 1536))] * 2 if fused else [])
    assert len(got) == len(want) == 2
    for (tok, cls), (jtok, jcls) in zip(got, want):
        for g, w in ((tok, jtok), (cls, jcls)):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=TOKEN_TOL * max(1.0, float(np.abs(w).max())))


def test_fused_mlp_plain_matches_jax_at_vitg_widths():
    """1536 -> 6144 -> 1536 on 37 rows (not a multiple of JAX's 512-row
    tile)."""
    from endodav_tpu.kernels import fused_mlp as jfm

    rng = np.random.default_rng(42)
    c, h, rows = 1536, 6144, 37
    args = ((rng.standard_normal((rows, c))).astype(np.float32),
            (rng.standard_normal((c, h)) * c ** -0.5).astype(np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32),
            (rng.standard_normal((h, c)) * h ** -0.5).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))
    got = fused_mlp(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfm.mlp_reference(*map(jnp.asarray, args))),
                               atol=REF_TOL)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jfm.fused_mlp(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want_kernel, atol=KERNEL_TOL)


@pytest.mark.parametrize("c,h,c2,want", [
    (1536, 6144, 1536, (6, 64)),  # vitg: 64-row tiles on a cluster of 6
    (2048, 8192, 2048, (8, 64)),  # the widest: Hopper's portable cluster of 8
    (1280, 5120, 1280, (5, 64)),
    (1024, 4096, 1024, (4, 128)),  # vitl, as before: 128-row tiles up to 4 CTAs
])
def test_mlp_config_takes_vitg_and_wider(c, h, c2, want):
    assert mlp_config(c, h, c2) == want


@pytest.mark.parametrize("c,h,c2,named", [
    (1536, 6144, 2056, "output width 2056"),  # 9 CTAs
    (1536, 6000, 1536, "1536 -> 6000 -> 1536"),  # H not a multiple of 32 * 6
    (1536, 6144, 1540, "output width 1540"),  # not a multiple of 8
])
def test_mlp_config_names_the_width_it_refuses(c, h, c2, named):
    with pytest.raises(ValueError, match=named):
        mlp_config(c, h, c2)
