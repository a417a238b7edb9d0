"""Port parity: the two serving-path kernels' plain versions against the
JAX package on the CPU (Pallas in interpret mode, as tests/test_kernels.py
runs it), the wrappers' dispatch rules, and the kernels against their
plain versions on a CUDA card (`test_torch_port_cuda.py`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention
from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block, rows_per_block

torch.set_num_threads(1)


def _qkv_inputs(seed, b, n, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal((c, 3 * c)) * 0.1).astype(np.float32)  # JAX layout [C, 3C]
    bias = rng.standard_normal((3 * c,)).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("n", [321, 600])
def test_qkv_attention_plain_matches_pallas_interpret(n):
    """The port's plain path (packed projection -> qkv_attention on CPU)
    against the Pallas qkv_flash_attention in interpret mode."""
    from endodav_tpu.kernels import flash_attention as fa
    from endodav_tpu_torch.ops.attention import fused_qkv_attention

    b, h, dh = 1, 3, 32
    x, w, bias = _qkv_inputs(5, b, n, h * dh)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fa.qkv_flash_attention(jnp.asarray(x), jnp.asarray(w),
                                                 jnp.asarray(bias), h)).reshape(b, n, h * dh)
    got = fused_qkv_attention(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                              torch.from_numpy(bias), h).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_attention_reference_matches_xla_oracle():
    from endodav_tpu.ops.attention import _xla_attention

    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 37, 4, 16)).astype(np.float32) for _ in range(3))
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25))
    got = attention_reference(*map(torch.from_numpy, (q, k, v)), 0.25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _block_inputs(seed, bstar, t, c):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa: E731
    return (f(bstar, t, c), f(c) + 1.0, f(c), f(t, c), f(c, c), f(c, c), f(c, c), f(c, c), f(c))


@pytest.mark.parametrize("c,bstar,t", [(64, 40, 32), (192, 24, 32), (64, 7, 5)])
def test_temporal_block_plain_matches_jax(c, bstar, t):
    from endodav_tpu.kernels import fused_temporal_block as jft

    args = _block_inputs(c + bstar, bstar, t, c)
    got = fused_temporal_block(*map(torch.from_numpy, args), 8).numpy()
    want_ref = np.asarray(jft.reference_block(*map(jnp.asarray, args), heads=8))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jft.fused_temporal_block(*map(jnp.asarray, args), 8, 16))
    np.testing.assert_allclose(got, want_ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got, want_kernel, atol=1e-4, rtol=1e-5)


def test_wrappers_reject_devices_they_cannot_serve():
    """A wrapper runs its plain version only for CPU tensors; anything else
    launches the kernel or raises."""
    qkv = torch.empty((1, 8, 3 * 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qkv_attention(qkv, 2)
    x = torch.empty((2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_temporal_block(x, *[torch.empty(0, device="meta")] * 8)


def test_cuda_call_without_toolkit_raises(monkeypatch, tmp_path):
    """On a CUDA tensor and without nvcc, both wrappers raise instead of
    falling back (fake CUDA tensors stand in for a card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; test_torch_port_cuda.py covers it")
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    before = (qkv_attention.launches, fused_temporal_block.launches)
    with FakeTensorMode():
        qkv = torch.empty((2, 40, 3 * 384), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            qkv_attention(qkv, 6)
        c, t = 64, 8
        vec = torch.empty(c, device="cuda")
        w = torch.empty(c, c, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            fused_temporal_block(torch.empty(3, t, c, device="cuda"), vec, vec,
                                 torch.empty(t, c, device="cuda"), w, w, w, w, vec, 8)
    assert (qkv_attention.launches, fused_temporal_block.launches) == before


def test_temporal_block_wide_channels_reach_grouped_launcher(monkeypatch, tmp_path):
    """vitl's C=1024 goes to the head-grouped kernel's launcher (the
    ungrouped layout exceeds a Hopper block's shared memory); without nvcc
    it raises there and counts no launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; test_torch_port_cuda.py covers it")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from endodav_tpu_torch.kernels import fused_temporal_block as ftb

    assert rows_per_block(32, 64) == 2 and rows_per_block(32, 384) == 1
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    before = (fused_temporal_block.launches, ftb.launch_grouped.launches)
    with FakeTensorMode():
        c, t = 1024, 32
        vec = torch.empty(c, device="cuda")
        w = torch.empty(c, c, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc") as err:
            fused_temporal_block(torch.empty(4, t, c, device="cuda"), vec, vec,
                                 torch.empty(t, c, device="cuda"), w, w, w, w, vec, 8)
    assert any(entry.name == "launch_grouped" for entry in err.traceback)
    assert (fused_temporal_block.launches, ftb.launch_grouped.launches) == before
