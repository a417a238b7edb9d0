"""Port parity for the vitl serving slice's kernels and int8 GEMMs on the
CPU: the head-grouped temporal block's and the fused MLP's plain versions
against the JAX package (Pallas in interpret mode, as tests/test_kernels.py
runs it, and the XLA oracles), `int8_dense` and the int8 fused-qkv path
against JAX's, the env rules of `resolve_int8`, and the ViT's routing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_reference
from endodav_tpu_torch.kernels.fused_temporal_block import (fused_temporal_block, head_groups,
                                                             reference_block)
from endodav_tpu_torch.ops import quant

torch.set_num_threads(1)


def _block_inputs(seed, bstar, t, c):
    rng = np.random.default_rng(seed)
    f = lambda *s, sd=0.2: (rng.standard_normal(s) * sd).astype(np.float32)  # noqa: E731
    return (f(bstar, t, c, sd=0.5), f(c) + 1.0, f(c), f(t, c), *(f(c, c, sd=c ** -0.5)
                                                                 for _ in range(4)), f(c))


@pytest.mark.parametrize("c,t,bstar", [(512, 32, 3), (1024, 32, 2), (1024, 5, 3), (512, 5, 9)])
def test_grouped_plain_matches_jax(c, t, bstar):
    """The wrapper's CPU path at C >= 512 (the grouped plain version)
    against JAX's head-grouped Pallas kernel in interpret mode and against
    its reference_block; f32, 1e-4 (the group partial sums and the single
    product sum in different orders)."""
    from endodav_tpu.kernels import fused_temporal_block as jft

    args = _block_inputs(c + t, bstar, t, c)
    got = fused_temporal_block(*map(torch.from_numpy, args), 8).numpy()
    want_ref = np.asarray(jft.reference_block(*map(jnp.asarray, args), heads=8))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jft.fused_temporal_block(*map(jnp.asarray, args), 8,
                                                          jft.default_rows(c, bstar)))
    np.testing.assert_allclose(got, want_ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got, want_kernel, atol=1e-4, rtol=1e-5)
    plain = reference_block(*map(torch.from_numpy, args), 8).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5)


def test_head_groups_match_jax():
    """The grouping rule of `_forward_grouped` (:210-212)."""
    for c, heads, want in ((1024, 8, 4), (512, 8, 2), (1024, 16, 4), (768, 8, 1), (1536, 8, 1)):
        assert head_groups(c, heads) == want


def _mlp_inputs(seed, rows, c, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, c)).astype(np.float32),
            (rng.standard_normal((c, h)) * c ** -0.5).astype(np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32),
            (rng.standard_normal((h, c)) * h ** -0.5).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("rows", [600, 37])
def test_fused_mlp_plain_matches_jax(rows):
    """vits widths (384 -> 1536 -> 384), rows not a multiple of the Pallas
    512-row tile: the plain version against JAX's `mlp_reference` (exact
    gelu) at 1e-5 and the Pallas kernel in interpret mode (erf by
    Abramowitz-Stegun, |error| <= 1.5e-7) at 1e-4."""
    from endodav_tpu.kernels import fused_mlp as jfm

    args = _mlp_inputs(rows, rows, 384, 1536)
    got = fused_mlp(*map(torch.from_numpy, args)).numpy()
    want_ref = np.asarray(jfm.mlp_reference(*map(jnp.asarray, args)))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jfm.fused_mlp(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want_ref, atol=1e-5)
    np.testing.assert_allclose(got, want_kernel, atol=1e-4)


def test_fused_mlp_plain_keeps_the_dtype_chain():
    """bf16 inputs: the hidden is rounded to bf16 between the products, as
    JAX's mlp_reference does (bf16 output, compared at its resolution)."""
    from endodav_tpu.kernels import fused_mlp as jfm

    x, w1, b1, w2, b2 = _mlp_inputs(3, 24, 64, 256)
    got = mlp_reference(torch.from_numpy(x).bfloat16(), torch.from_numpy(w1).bfloat16(),
                        torch.from_numpy(b1), torch.from_numpy(w2).bfloat16(),
                        torch.from_numpy(b2))
    want = jfm.mlp_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16),
                             jnp.asarray(b1), jnp.asarray(w2, jnp.bfloat16), jnp.asarray(b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("shape,cout", [((2, 37, 96), 48), ((130, 64), 40)])
def test_int8_dense_matches_jax(shape, cout):
    """Same quantization (round half to even, clip 127), an exact integer
    product, the same f32 epilogue: equal to JAX's up to the epilogue's
    f32 rounding."""
    from endodav_tpu.ops.quant import int8_dense as jint8

    rng = np.random.default_rng(cout)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], cout)) * 0.2).astype(np.float32)  # JAX [in, out]
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jint8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    w8, scale = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    from endodav_tpu.ops.quant import quantize_weight as jqw

    jw8, jscale = jqw(jnp.asarray(w))
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_int8_matmul_is_exact_beyond_f32():
    """Sums of 127*127 products over K=4096 reach 6.6e7, past f32's 2^24:
    the plain contraction is exact."""
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    w = torch.full((8, 4096), 127, dtype=torch.int8)
    w[0, 0] = 126
    acc = quant.int_matmul(a, w)
    assert acc[0, 0].item() == 127 * 127 * 4096 - 127
    assert acc[0, 1].item() == 127 * 127 * 4096


def test_int8_qkv_attention_matches_jax(monkeypatch):
    """The int8 fused-qkv path (one per-row quantization of x, shared by
    the q/k/v panels) against JAX's `qkv_flash_attention(quant_int8=True)`
    in interpret mode."""
    from endodav_tpu.kernels.flash_attention import qkv_flash_attention

    from endodav_tpu_torch.ops.attention import fused_qkv_attention

    monkeypatch.delenv("ENDODAV_INT8", raising=False)
    rng = np.random.default_rng(9)
    b, n, c, h = 1, 200, 128, 2
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal((c, 3 * c)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(qkv_flash_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), h,
                                              quant_int8=True)).reshape(b, n, c)
    got = fused_qkv_attention(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                              torch.from_numpy(bias), h, quant_int8=True).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_resolve_int8_env_rules(monkeypatch):
    """An explicitly set ENDODAV_INT8 wins both ways, with the falsy
    spellings meaning off; unset, the model's flag decides, as in JAX."""
    from endodav_tpu.ops.quant import resolve_int8 as jresolve

    monkeypatch.delenv("ENDODAV_INT8", raising=False)
    for flag in (None, False, True):
        assert quant.resolve_int8(flag) == jresolve(flag) == bool(flag)
    for value in ("0", "false", "False", "off", "no", "", "  ", "1", "true", "yes"):
        monkeypatch.setenv("ENDODAV_INT8", value)
        for flag in (False, True):
            assert quant.resolve_int8(flag) == jresolve(flag), (value, flag)


def _tiny_vit(**kw):
    from endodav_tpu_torch.eval.engine import init_random_
    from endodav_tpu_torch.models.vit import DinoViT

    return init_random_(DinoViT(embed_dim=64, depth=2, num_heads=1, **kw), seed=3)


def test_vit_routes_int8_and_fused_mlp(monkeypatch):
    """`quant_int8` changes the merged trunk's output (the int8 GEMMs ran)
    and stays close; ENDODAV_INT8=0 forces it off; ENDODAV_FUSED_MLP=1
    sends the merged MLP through `fused_mlp` (its plain version on the
    CPU: the same output), but not with int8 or an adapted MLP."""
    from endodav_tpu_torch.kernels import fused_mlp as fm
    from endodav_tpu_torch.models import vit as vit_mod

    monkeypatch.delenv("ENDODAV_INT8", raising=False)
    monkeypatch.delenv("ENDODAV_FUSED_MLP", raising=False)
    images = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 42, 56, 3))
                              .astype(np.float32))
    vit = _tiny_vit()
    with torch.inference_mode():
        base = vit(images, (1,))[0][0]
        q8 = vit(images, (1,), quant_int8=True)[0][0]
        monkeypatch.setenv("ENDODAV_INT8", "0")
        off = vit(images, (1,), quant_int8=True)[0][0]
        monkeypatch.delenv("ENDODAV_INT8")
    assert 0 < (q8 - base).abs().max().item() < 0.1
    assert torch.equal(off, base)

    calls = []
    monkeypatch.setattr(vit_mod, "fused_mlp", lambda *a: calls.append(1) or fm.fused_mlp(*a))
    monkeypatch.setenv("ENDODAV_FUSED_MLP", "1")
    with torch.inference_mode():
        fused = vit(images, (1,))[0][0]
        assert len(calls) == 2
        vit(images, (1,), quant_int8=True)
        _tiny_vit(lora_variant="dvlora")(images, (1,))
    assert len(calls) == 2
    torch.testing.assert_close(fused, base, atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_reject_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp(x, *[torch.empty(0, device="meta")] * 4)
    with pytest.raises(ValueError, match="unsupported device"):
        quant.int_matmul(torch.empty((32, 8), dtype=torch.int8, device="meta"),
                         torch.empty((8, 8), dtype=torch.int8, device="meta"))
