"""The tensor-core flash attention and fused RCU on the CPU: plain
emulations of the kernels' f32 arithmetic (`tf32x3_attention`,
`taps_emulation`) against float64 and against the JAX package (its RCU
kernel in Pallas interpret mode), the k-slot order that lets the attention
kernel feed S's accumulator to P V unshuffled, and the RCU wrapper's
weight planes, made once per weight version.  The kernels themselves run
in `test_torch_port_cuda.py` on a card."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels import flash_attention as fa
from endodav_tpu_torch.kernels import fused_rcu as fr
from endodav_tpu_torch.kernels.tf32x3 import split_tf32

torch.set_num_threads(1)


def _attention64(q, k, v, scale):
    """Attention over [B, N, H, Dh] in float64."""
    q, k, v = (t.double() for t in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("n", [321, 1703])
def test_attention_emulation_keeps_f32_accuracy(n):
    """q, k, P and V split to TF32, 64-key tiles summed from zero with P V's
    keys in the k-slot order, the online rescale: within 2e-6 of
    max(1, |ref|) of float64 at N=321 (a one-key last tile) and N=1703,
    where one TF32 pass is not."""
    rng = np.random.default_rng(n)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 2, 64)).astype(np.float32))
               for _ in range(3))
    ref = _attention64(q, k, v, 0.125)
    bound = 2e-6 * max(1.0, ref.abs().max().item())
    got = fa.tf32x3_attention(q, k, v, 0.125)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert (got.double() - ref).abs().max().item() <= bound
    one_pass = fa.attention_reference(*(split_tf32(t)[0] for t in (q, k, v)), 0.125)
    assert (one_pass.double() - ref).abs().max().item() > 10 * bound


def test_attention_slot_order_matches_the_fragments():
    """mma.m16n8k8's fragments: lane t of a quad holds S's columns 2t and
    2t+1 (accumulator c0, c1) and gives A's k-slots t and t+4 (a0, a2).
    Feeding c0 as a0 and c1 as a2 puts key 2t in slot t and key 2t+1 in
    slot t+4, the order `SLOT_KEYS` gives V's rows."""
    slot_of_key = {}
    for t in range(4):
        slot_of_key[2 * t] = t          # c0 -> a0
        slot_of_key[2 * t + 1] = t + 4  # c1 -> a2
    assert tuple(key for slot in range(8) for key in range(8)
                 if slot_of_key[key] == slot) == fa.SLOT_KEYS


def test_attention_emulation_matches_the_plain_version_on_ragged_tiles():
    """N below one tile and just past it, two heads: the emulation and the
    plain version (the wrapper's CPU path) agree to f32."""
    for n in (1, 63, 65):
        rng = np.random.default_rng(n + 100)
        q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 2, 64)).astype(np.float32))
                   for _ in range(3))
        want = fa.attention_reference(q, k, v, 0.125)
        got = fa.tf32x3_attention(q, k, v, 0.125)
        assert (got - want).abs().max().item() <= 2e-6


def _rcu_params(c, seed):
    rng = np.random.default_rng(seed)
    w1, w2 = ((rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5).astype(np.float32)
              for _ in range(2))
    b1, b2 = ((rng.standard_normal(c) * 0.1).astype(np.float32) for _ in range(2))
    return w1, b1, w2, b2


def _torch_weights(w1, b1, w2, b2):
    """JAX HWIO kernels -> torch [C_out, C_in, 3, 3] tensors."""
    def tw(w):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))

    return tw(w1), torch.from_numpy(b1), tw(w2), torch.from_numpy(b2)


@pytest.mark.parametrize("b,h,w,c", [
    (2, 5, 7, 4),       # smaller than one 8x16 tile, C padded to 16 in the kernel
    (1, 19, 23, 64),    # refinenet4's size, not a tile multiple
    (2, 8, 16, 64),     # exactly one tile
    (1, 9, 17, 128),    # C=128, one pixel past a tile each way
])
def test_rcu_tap_emulation_matches_reference_and_jax(b, h, w, c):
    """Nine shifted products over the K-major taps per 8x16 tile with the
    intermediate zeroed outside the image: within 2e-6 of max(1, |ref|) of
    the float64 plain version, and within 1e-5 (tests/test_fused_rcu.py's
    bound) of JAX's Pallas kernel in interpret mode."""
    from endodav_tpu.kernels.fused_rcu import fused_rcu as jfused_rcu

    x = np.random.default_rng(b * h * w + c).standard_normal((b, h, w, c)).astype(np.float32)
    params = _rcu_params(c, seed=h + c)
    weights = _torch_weights(*params)
    xt = torch.from_numpy(x)
    got = fr.taps_emulation(xt, *weights)
    ref = fr.rcu_reference(xt.double(), *(t.double() for t in weights))
    assert got.shape == xt.shape and got.dtype == torch.float32
    assert (got.double() - ref).abs().max().item() <= 2e-6 * max(1.0, ref.abs().max().item())
    want = np.asarray(jfused_rcu(jnp.asarray(x), *map(jnp.asarray, params), 8, True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [4, 64])
def test_rcu_tap_emulation_bf16_dtype_chain(c):
    """bf16: the intermediate and conv2's output rounded to bf16 as the TPU
    kernel's dtype chain: within 3e-2 of max(1, |ref|) of the plain
    version on the same bf16 inputs, in f32."""
    x = torch.from_numpy(np.random.default_rng(c).standard_normal((2, 11, 19, c))
                         .astype(np.float32)).bfloat16()
    w1, b1, w2, b2 = _torch_weights(*_rcu_params(c, seed=c + 1))
    got = fr.taps_emulation(x, w1, b1, w2, b2)
    assert got.dtype == torch.bfloat16
    ref = fr.rcu_reference(x.float(), w1.bfloat16().float(), b1, w2.bfloat16().float(), b2)
    assert (got.float() - ref).abs().max().item() <= 3e-2 * max(1.0, ref.abs().max().item())


def test_padded_width_mirrors_the_kernel():
    assert [fr.padded_width(c) for c in (4, 16, 20, 32, 36, 64, 68, 128)] == \
        [16, 16, 32, 32, 64, 64, 128, 128]


class _Recorder:
    """Stands in for the kernels' shared library: records the RCU launch's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def endodav_fused_rcu(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorded(monkeypatch):
    """`fused_rcu._launch` on CPU tensors, its library a `_Recorder`."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(fr.fused_rcu, "planes", type(fr.fused_rcu.planes)())
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rcu_planes_made_once_and_remade_after_an_update(recorded, dtype):
    """A second launch with the same convolutions passes the same tap
    planes (cache hits, nothing rebuilt); an in-place update of a weight
    makes new planes, which hold the updated taps: f32 as TF32 hi and lo
    planes of the padded K-major taps, bf16 as the taps once."""
    c = 36
    convs = [torch.nn.Conv2d(c, c, 3, padding=1) for _ in range(2)]
    x = torch.randn(1, 5, 9, c).to(dtype)
    args = lambda: (x, convs[0].weight, convs[0].bias, convs[1].weight, convs[1].bias)  # noqa: E731
    fr._launch(*args())
    fr._launch(*args())
    first, second = recorded.calls
    planes = fr.fused_rcu.planes
    assert first[1:8] == second[1:8] and planes.misses == 2 and planes.hits == 2
    assert first[0] == _build.DTYPE_CODES[dtype] and first[9:13] == (1, 5, 9, c)
    with torch.no_grad():
        convs[1].weight.mul_(2.0)
    fr._launch(*args())
    third = recorded.calls[2]
    assert third[2:4] == first[2:4] and third[5:7] != first[5:7] and planes.misses == 3
    hi, lo = fr._planes(convs[1].weight, dtype)
    assert (hi.data_ptr(), lo.data_ptr()) == third[5:7]
    taps = fr.kernel_taps(convs[1].weight, dtype, 64)
    assert hi.shape == (9, 64, 64)
    assert torch.all(taps[:, c:] == 0) and torch.all(taps[:, :, c:] == 0)
    if dtype == torch.float32:
        assert torch.equal(hi, split_tf32(taps)[0]) and torch.equal(lo, split_tf32(taps)[1])
    else:
        assert hi is lo and torch.equal(hi, taps)
