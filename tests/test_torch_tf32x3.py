"""The 3xTF32 route of the tensor-core kernels on the CPU: the TF32 split
against a numpy model of `cvt.rna.tf32.f32`, a plain emulation of the
kernels' three-pass product against float64 (and one TF32 pass, which
the f32 tolerance tells apart), a numpy model of the tensor core's
accumulation in both orders of `csrc/tc_tile.cuh`, the weight-plane
cache, the weight layouts the two wrappers take, and the widths they
route."""

import numpy as np
import pytest
import torch

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels import fused_temporal_block as ftb
from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_config
from endodav_tpu_torch.kernels.tf32x3 import (PlaneCache, check_layout, kmajor_planes, split_tf32,
                                              tf32x3_matmul)

torch.set_num_threads(1)

F32_TOL = 1e-4  # the kernels' f32 tolerance, of max(1, the largest entry)


def _rna_model(w: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the bit pattern: round to nearest with ties
    away from zero at bit 13, in unsigned arithmetic."""
    bits = w.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _special_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(4096).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -30, 30, 4096).astype(np.float32)
    base = rng.integers(1 << 23, 1 << 24, 64, dtype=np.uint32) & ~np.uint32(0x1FFF)
    ties = (base | np.uint32(0x1000)).view(np.float32)  # exactly half-way: away from zero
    below = (base | np.uint32(0x0FFF)).view(np.float32)  # just below half-way: down
    sub = (rng.integers(1, 1 << 23, 256, dtype=np.uint32)).view(np.float32)  # subnormals
    fixed = np.array([0.0, -0.0, 1.0, -1.0, 1.5, np.finfo(np.float32).tiny,
                      -np.finfo(np.float32).tiny, 65504.0, 1e-38, -3e-39], np.float32)
    vals = np.concatenate([normal, ties, below, sub, fixed])
    return np.concatenate([vals, -vals]).astype(np.float32)


def test_split_matches_cvt_rna_bit_for_bit():
    """hi and lo equal the numpy model of the instruction bit for bit
    (ties away from zero, both signs, signed zeros, subnormals); the low 13
    bits of both are clear; and at normal magnitudes w - hi - lo is at
    most 2^-22 of |w| (w - hi is exact in f32)."""
    w = _special_values()
    hi, lo = split_tf32(torch.from_numpy(w))
    hi, lo = hi.numpy(), lo.numpy()
    want_hi = _rna_model(w)
    want_lo = _rna_model((w - want_hi).astype(np.float32))
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), want_lo.view(np.uint32))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    # ties go away from zero, just-below-ties go toward it
    tie = (np.uint32(0x3F800000) | np.uint32(0x1000)).view(np.float32)
    for sign in (1, -1):
        got = split_tf32(torch.tensor([sign * tie]))[0].numpy()
        assert got[0] == sign * (np.uint32(0x3F802000).view(np.float32))
    normal = np.abs(w) >= 2.0 ** -100
    resid = np.abs(w.astype(np.float64) - hi - lo)
    assert (resid[normal] <= 2.0 ** -22 * np.abs(w[normal])).all()
    assert (hi[w == 0] == 0).all() and (lo[w == 0] == 0).all()
    with pytest.raises(TypeError, match="float32"):
        split_tf32(torch.zeros(3, dtype=torch.bfloat16))


@pytest.mark.parametrize("k,n", [(1024, 4096), (4096, 1024), (1024, 3072)])
def test_three_pass_product_keeps_f32_accuracy(k, n):
    """The fc1, fc2 and q|k|v widths: the 3xTF32 emulation stays within
    1e-4 of max(1, |ref|) of the float64 product (as close as the f32
    product itself); one TF32 pass does not, so the tolerance tells the
    two apart."""
    rng = np.random.default_rng(k + n)
    a = rng.standard_normal((64, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = max(1.0, np.abs(ref).max())
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    three = np.abs(tf32x3_matmul(ta, tb).double().numpy() - ref).max() / scale
    one = np.abs((split_tf32(ta)[0] @ split_tf32(tb)[0]).double().numpy() - ref).max() / scale
    plain = np.abs((ta @ tb).double().numpy() - ref).max() / scale
    assert three <= F32_TOL and three <= 4 * plain
    assert one > F32_TOL


def _cut_to_f32(s: np.ndarray) -> np.ndarray:
    """float64 -> f32 rounded toward zero."""
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma_model(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One m16n8k8 TF32 pass as a tensor core adds it to acc: the products
    of TF32 values exact, every addend (acc among them) aligned to the
    largest one's exponent with the bits below f32 precision cut toward
    zero, the sum cut toward zero to f32.  a [M, 8], b [8, N] hold TF32
    values; acc [M, N] f32."""
    terms = a.astype(np.float64)[:, None, :] * b.astype(np.float64).T[None, :, :]
    addends = np.concatenate([acc.astype(np.float64)[..., None], terms], -1)
    top = np.abs(addends).max(-1, keepdims=True)
    quantum = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
    return _cut_to_f32((np.trunc(addends / quantum) * quantum).sum(-1))


def _tile_model(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """a @ b in the warp tile's order: per k-step of 8 the passes a_lo*b_hi,
    a_hi*b_lo, a_hi*b_hi, either straight into the running sum (steps=0,
    the order before the repair) or into a partial from zero that is added
    to the running sum, rounded to nearest, every `steps` k-steps (2: the
    kernels' order, csrc/tc_tile.cuh)."""
    (ahi, alo), (bhi, blo) = ((_rna_model(x), _rna_model(x - _rna_model(x))) for x in (a, b))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(acc)
    for i, k0 in enumerate(range(0, a.shape[1], 8)):
        ks = slice(k0, k0 + 8)
        for x, y in ((alo[:, ks], bhi[ks]), (ahi[:, ks], blo[ks]), (ahi[:, ks], bhi[ks])):
            if steps:
                part = _mma_model(part, x, y)
            else:
                acc = _mma_model(acc, x, y)
        if steps and (i + 1) % steps == 0:
            acc = (acc.astype(np.float64) + part).astype(np.float32)
            part = np.zeros_like(acc)
    return acc


@pytest.mark.parametrize("dist", ["signed", "positive"])
def test_promoted_accumulation_keeps_f32_accuracy_at_k4096(dist):
    """The tile's order (a partial of two k-steps promoted into the running
    sum), modelled with the tensor core's cuts toward zero, stays within
    half the kernels' f32 tolerance of float64 at fc2's K = 4096; on
    same-sign data, where every cut has one sign, the direct order's error
    is many times larger."""
    rng = np.random.default_rng(4096)
    k = 4096
    a = rng.standard_normal((16, k)).astype(np.float32)
    b = (rng.standard_normal((k, 16)) * k ** -0.5).astype(np.float32)
    if dist == "positive":
        a, b = np.abs(a), np.abs(b)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = max(1.0, np.abs(ref).max())
    promoted = np.abs(_tile_model(a, b, 2) - ref).max() / scale
    direct = np.abs(_tile_model(a, b, 0) - ref).max() / scale
    assert promoted <= F32_TOL / 2
    if dist == "positive":
        assert direct > 10 * promoted


def test_plane_cache_hits_for_the_same_view_and_splits_after_an_update():
    lin = torch.nn.Linear(64, 96)
    cache = PlaneCache()
    hi, lo = kmajor_planes(cache, lin.weight.t())
    assert (cache.hits, cache.misses) == (0, 1)
    assert hi.shape == (96, 64) and hi.is_contiguous()  # K-major: the parameter's own layout
    torch.testing.assert_close(hi + lo, lin.weight.detach(), rtol=0, atol=1e-6)
    again = kmajor_planes(cache, lin.weight.t())
    assert (cache.hits, cache.misses) == (1, 1) and again[0] is hi
    with torch.no_grad():
        lin.weight.mul_(2.0)
    hi2, lo2 = kmajor_planes(cache, lin.weight.t())
    assert cache.misses == 2 and hi2 is not hi
    torch.testing.assert_close(hi2 + lo2, lin.weight.detach(), rtol=0, atol=2e-6)
    # a JAX-layout contiguous weight gets a K-major copy, also kept
    w = torch.randn(64, 96)
    h3, l3 = kmajor_planes(cache, w)
    assert kmajor_planes(cache, w)[0] is h3 and h3.shape == (96, 64) and h3.is_contiguous()
    torch.testing.assert_close(h3 + l3, w.t(), rtol=0, atol=1e-6)


def test_plane_cache_forgets_dead_weights_and_stays_bounded():
    cache = PlaneCache(limit=3)
    lin = torch.nn.Linear(8, 8)
    kmajor_planes(cache, lin.weight.t())
    assert len(cache) == 1
    del lin
    assert len(cache) == 0  # the parameter died: its entry went with it
    keep = [torch.randn(8, 8) for _ in range(5)]
    for w in keep:
        kmajor_planes(cache, w)
    assert len(cache) == 3


def test_bf16_kmajor_view_needs_no_copy():
    lin = torch.nn.Linear(32, 16).to(torch.bfloat16)
    cache = PlaneCache()
    hi, lo = kmajor_planes(cache, lin.weight.t())
    assert hi.data_ptr() == lo.data_ptr() == lin.weight.data_ptr() and hi.is_contiguous()
    assert len(cache) == 0
    w = torch.randn(32, 16).bfloat16()
    hi, lo = kmajor_planes(cache, w)
    assert torch.equal(hi, w.t()) and hi.is_contiguous() and len(cache) == 1


def test_layouts_taken_and_refused():
    w = torch.randn(48, 32)
    check_layout(w, "w")
    check_layout(w.t(), "w")
    for bad in (w[:, ::2], w[::2], torch.randn(4, 48, 32)[1:3, 0], torch.randn(8)):
        with pytest.raises(ValueError, match="contiguous or the transpose"):
            check_layout(bad, "w")


@pytest.mark.parametrize("c,h,c2,want", [(384, 1536, 384, (2, 128)), (1024, 4096, 1024, (4, 128)),
                                         (64, 256, 64, (1, 128)), (512, 3072, 768, (3, 128))])
def test_mlp_config_mirrors_the_kernel(c, h, c2, want):
    assert mlp_config(c, h, c2) == want


@pytest.mark.parametrize("c,h,c2", [(48, 256, 64), (384, 1600, 384), (64, 256, 1030),
                                    (64, 250, 64), (64, 256, 63)])
def test_mlp_config_refuses_other_widths(c, h, c2):
    with pytest.raises(ValueError, match="fused_mlp"):
        mlp_config(c, h, c2)


def _no_toolkit(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; test_torch_port_cuda.py covers it")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)


@pytest.mark.parametrize("view", ["contiguous", "transposed"])
def test_wrappers_take_transposed_views(monkeypatch, tmp_path, view):
    """On CUDA tensors (fake ones, no card) both wrappers accept JAX-layout
    weights that are contiguous or the `.t()` view of a torch-layout
    parameter, and go on to build the kernels (no nvcc here: it raises
    there, with no launch counted)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _no_toolkit(monkeypatch, tmp_path)
    before = (fused_mlp.launches, ftb.fused_temporal_block.launches)
    with FakeTensorMode():
        w = (lambda i, o: torch.empty(i, o, device="cuda") if view == "contiguous"  # noqa: E731
             else torch.empty(o, i, device="cuda").t())
        b = lambda n: torch.empty(n, device="cuda")  # noqa: E731
        with pytest.raises(RuntimeError, match="nvcc"):
            fused_mlp(torch.empty(5, 384, device="cuda"), w(384, 1536), b(1536), w(1536, 384),
                      b(384))
        for c, t in ((64, 8), (1024, 32)):
            with pytest.raises(RuntimeError, match="nvcc"):
                ftb.fused_temporal_block(torch.empty(2, t, c, device="cuda"), b(c), b(c),
                                         torch.empty(t, c, device="cuda"), w(c, c), w(c, c),
                                         w(c, c), w(c, c), b(c), 8)
    assert (fused_mlp.launches, ftb.fused_temporal_block.launches) == before


def test_wrappers_refuse_other_strides(monkeypatch, tmp_path):
    """A weight that is neither contiguous nor a transposed contiguous
    tensor raises before anything is built."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _no_toolkit(monkeypatch, tmp_path)
    with FakeTensorMode():
        b = lambda n: torch.empty(n, device="cuda")  # noqa: E731
        def strided(i, o):  # every other column of an [i, 2o] buffer
            return torch.empty_strided((i, o), (2 * o, 2), device="cuda")

        with pytest.raises(ValueError, match="contiguous or the transpose"):
            fused_mlp(torch.empty(5, 384, device="cuda"), strided(384, 1536), b(1536),
                      torch.empty(1536, 384, device="cuda"), b(384))
        for c, t in ((64, 8), (1024, 32)):
            w = torch.empty(c, c, device="cuda")
            with pytest.raises(ValueError, match="contiguous or the transpose"):
                ftb.fused_temporal_block(torch.empty(2, t, c, device="cuda"), b(c), b(c),
                                         torch.empty(t, c, device="cuda"), w, w, w,
                                         strided(c, c), b(c), 8)


def test_grouped_route_refuses_widths_it_cannot_tile(monkeypatch, tmp_path):
    """C=640 (column tiles of 64 would make a cluster of 10) or heads
    wider than 128: raises (nothing falls back to another kernel or the
    plain version)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _no_toolkit(monkeypatch, tmp_path)
    with FakeTensorMode():
        for c, heads in ((640, 8), (1024, 4)):
            vec = torch.empty(c, device="cuda")
            w = torch.empty(c, c, device="cuda")
            with pytest.raises(ValueError, match="grouped route"):
                ftb.fused_temporal_block(torch.empty(2, 8, c, device="cuda"), vec, vec,
                                         torch.empty(8, c, device="cuda"), w, w, w, w, vec,
                                         heads)


def test_models_pass_parameter_views(monkeypatch):
    """The ViT MLP and the motion modules' attention hand the kernels
    `lin.weight.t()`, views of the parameters' own storage (no per-call
    copy); on the CPU the results are the unfused modules' on the same
    weights."""
    from endodav_tpu_torch.models import motion, vit

    seen = {}

    def spy(name, fn):
        def wrapped(*args):
            seen[name] = args
            return fn(*args)
        return wrapped

    monkeypatch.setattr(vit, "fused_mlp", spy("mlp", fused_mlp))
    monkeypatch.setattr(motion, "fused_temporal_block", spy("block", ftb.fused_temporal_block))
    monkeypatch.setenv("ENDODAV_FUSED_MLP", "1")
    mlp = vit.Mlp(64, 256, "none", 4, None)
    for lin in (mlp.fc1, mlp.fc2):
        torch.nn.init.normal_(lin.weight, std=0.1)
    x = torch.randn(2, 5, 64)
    attn = motion.TemporalAttention(64, 8)
    norm = torch.nn.LayerNorm(64, eps=1e-5)
    xt = torch.randn(3, 8, 64)
    with torch.no_grad():
        torch.testing.assert_close(mlp(x), mlp.fc2(torch.nn.functional.gelu(mlp.fc1(x))),
                                   rtol=1e-5, atol=1e-5)
        got = attn(xt, norm)
    want = ftb.reference_block(xt, norm.weight, norm.bias, attn.pe[:8], attn.to_q.weight.t(),
                               attn.to_k.weight.t(), attn.to_v.weight.t(),
                               attn.to_out[0].weight.t(), attn.to_out[0].bias, 8)
    torch.testing.assert_close(got, want.detach(), rtol=1e-5, atol=1e-5)
    _, w1, _, w2, _ = seen["mlp"]
    assert w1.data_ptr() == mlp.fc1.weight.data_ptr() and w1.t().is_contiguous()
    assert w2.data_ptr() == mlp.fc2.weight.data_ptr() and w2.t().is_contiguous()
    for w, lin in zip(seen["block"][4:8], (attn.to_q, attn.to_k, attn.to_v, attn.to_out[0])):
        assert w.data_ptr() == lin.weight.data_ptr() and not w.is_contiguous()
