"""Port parity: the two serving-path kernels' plain versions against the
JAX package on the CPU (Pallas in interpret mode, as tests/test_kernels.py
runs it), the wrappers' dispatch rules, and the kernels against their
plain versions on a CUDA card (`test_torch_port_cuda.py`)."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention
from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block, tile_config

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
    """vitl's C=1024 goes to the tensor-core route's launcher in column
    tiles of 256, one head a K step; without nvcc it raises there and
    counts no launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; test_torch_port_cuda.py covers it")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from endodav_tpu_torch.kernels import fused_temporal_block as ftb

    assert tile_config(1024, 8, torch.float32) == tile_config(1024, 8, torch.bfloat16) == (256, 1)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    before = fused_temporal_block.launches
    with FakeTensorMode():
        c, t = 1024, 32
        vec = torch.empty(c, device="cuda")
        w = torch.empty(c, c, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc") as err:
            fused_temporal_block(torch.empty(4, t, c, device="cuda"), vec, vec,
                                 torch.empty(t, c, device="cuda"), w, w, w, w, vec, 8)
    assert any(entry.name == "_launch" for entry in err.traceback)
    assert fused_temporal_block.launches == before


class _FakeLibrary:
    """Stands in for the kernels' shared library: records each call's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_library(monkeypatch):
    """The wrappers reach a `_FakeLibrary` through fake CUDA tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; test_torch_port_cuda.py launches the kernels")
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return lib


# every width the models build a motion module at: vits 64 (path_3/4), 192
# (layer_3), 384 (layer_4); vitl 256 (path_*) and 1024; -> (bn, hs) in f32
# and bf16 (16 and 32 columns a 64-byte stage)
WIDTHS = {64: ((64, 2), (64, 4)), 192: ((192, 2), (192, 4)), 256: ((256, 1), (256, 1)),
          384: ((192, 1), (192, 2)), 1024: ((256, 1), (256, 1))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", list(WIDTHS))
def test_temporal_block_routes_every_width_to_the_tensor_cores(fake_library, monkeypatch, c,
                                                                 dtype):
    """Every C the models build takes the one tensor-core route: one call
    of `endodav_fused_temporal_block` with the tiles of `tile_config` and
    one launch counted (the weight planes, which need a card to make, are
    the K-major views here; test_torch_tf32x3.py covers them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from endodav_tpu_torch.kernels import fused_temporal_block as ftb

    monkeypatch.setattr(ftb, "kmajor_planes", lambda cache, w: (w.t(), w.t()))
    want = WIDTHS[c][dtype == torch.bfloat16]
    assert tile_config(c, 8, dtype) == want
    before = fused_temporal_block.launches
    with FakeTensorMode():
        t, rows = 32, 3
        vec = torch.empty(c, device="cuda")
        w = torch.empty(c, c, device="cuda", dtype=dtype)
        out = fused_temporal_block(torch.empty(rows, t, c, device="cuda", dtype=dtype), vec, vec,
                                   torch.empty(t, c, device="cuda"), w, w, w, w,
                                   torch.empty(c, device="cuda", dtype=dtype), 8)
        assert out.shape == (rows, t, c) and out.dtype == dtype
    (name, args), = fake_library.calls
    assert name == "endodav_fused_temporal_block"
    assert args[0] == _build.DTYPE_CODES[dtype] and args[16:22] == (rows, t, c, 8, *want)
    assert args[22] == pytest.approx((c // 8) ** -0.5)
    assert fused_temporal_block.launches == before + 1


@pytest.mark.parametrize("t,dh,wpb", [(16, 8, 4), (32, 24, 4), (32, 48, 4), (32, 128, 4),
                                      (64, 128, 2), (5, 3, 4)])
def test_temporal_attention_launch_configuration(fake_library, t, dh, wpb):
    """One warp a (row, head), up to four a block while their shared
    memory fits a Hopper block; the kernel gets the warps a block and
    counts one launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from endodav_tpu_torch.kernels.temporal_attention import (temporal_attention, warp_bytes,
                                                              warps_per_block)

    assert warps_per_block(t, dh) == wpb and wpb * warp_bytes(t, dh) <= 232448
    before = temporal_attention.launches
    with FakeTensorMode():
        q = torch.empty(7, t, 8, dh, device="cuda")
        out = temporal_attention(q, q, q)
        assert out.shape == q.shape
    (name, args), = fake_library.calls
    assert name == "endodav_temporal_attention" and args[5:10] == (7, t, 8, dh, wpb)
    assert temporal_attention.launches == before + 1
