"""The port's CUDA kernels against their plain versions on a CUDA card.

Marked `cuda`; each test skips without a card (the kernels have no CPU
mode).  The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from endodav_tpu_torch.kernels import warp_matmul as W
from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention
from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block, reference_block

torch.set_num_threads(1)

# f32: summation order; bf16: 8-bit-mantissa inputs and intermediates,
# compared with the plain version in f32 on the same (rounded) inputs
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads", [(2, 97, 2), (1, 1, 6), (3, 321, 6)])
def test_flash_attention_matches_plain(dtype, b, n, heads):
    dev = _card()
    c = heads * 64
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32)).to(dev)
    qkv = qkv.to(dtype)
    want = attention_reference(*(qkv.float()[..., i * c:(i + 1) * c].reshape(b, n, heads, 64)
                                 for i in range(3)), 0.125).reshape(b, n, c)
    before = qkv_attention.launches
    got = qkv_attention(qkv, heads)
    torch.cuda.synchronize()
    assert qkv_attention.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t,c", [(9, 32, 64), (13, 8, 64), (5, 5, 192), (3, 32, 384)])
def test_fused_temporal_block_matches_plain(dtype, rows, t, c):
    dev = _card()
    rng = np.random.default_rng(rows * c + t)
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x = f(rows, t, c, sd=0.5)
    gamma, beta, pe = 1.0 + f(c), f(c), f(t, c)
    ws = [f(c, c, sd=c ** -0.5) for _ in range(4)]
    bo = f(c)
    args = [a.to(dtype) for a in (x, *ws, bo)]
    want = reference_block(args[0].float(), gamma, beta, pe, *(a.float() for a in args[1:5]),
                           args[5].float(), 8)
    before = fused_temporal_block.launches
    got = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


# warps: f32 outputs and coordinate grads to 1e-5 (one thread computes what
# the plain version computes, up to FMA contraction); d_img and the splat
# map are atomics-summed in a run-dependent order: relative 1e-4
WARP_TOL, ATOMIC_RTOL = 1e-5, 1e-4


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("c,zeros,tile,img_grad", [(3, False, 4, False), (1, True, 1, True),
                                                   (2, False, 1, True), (4, True, 2, False)])
def test_grid_sample_kernels_match_plain(c, zeros, tile, img_grad):
    dev = _card()
    rng = np.random.default_rng(c * 10 + tile)
    b, h, w = 3, 37, 53
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)).to(dev)
    # coordinates reach past every border
    fx = torch.from_numpy(rng.uniform(-3, w + 2, (b * tile, 11, 13)).astype(np.float32)).to(dev)
    fy = torch.from_numpy(rng.uniform(-3, h + 2, (b * tile, 11, 13)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((b * tile, 11, 13, c)).astype(np.float32)).to(dev)

    def run(fn):
        i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
        out = fn(i if img_grad else i.detach(), x, y)
        out.backward(g)
        return out.detach(), (i.grad if img_grad else None), x.grad, y.grad

    counts = (W.grid_sample_fwd_cuda.launches, W.grid_sample_bwd_coord_cuda.launches,
              W.grid_sample_bwd_fused_cuda.launches)
    got = run(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile))
    want = run(lambda i, x, y: W.grid_sample_reference(i, x, y, zeros, tile))
    torch.cuda.synchronize()
    assert W.grid_sample_fwd_cuda.launches == counts[0] + 1
    assert W.grid_sample_bwd_coord_cuda.launches == counts[1] + (not img_grad)
    assert W.grid_sample_bwd_fused_cuda.launches == counts[2] + img_grad
    for k in (0, 2, 3):
        assert (got[k] - want[k]).abs().max().item() <= WARP_TOL
    if img_grad:
        assert _rel(got[1], want[1]) <= ATOMIC_RTOL


@pytest.mark.cuda
def test_splat_kernel_matches_plain():
    dev = _card()
    rng = np.random.default_rng(5)
    b, h, w = 2, 29, 41
    x = torch.from_numpy(rng.uniform(-2, w + 1, (b, h * w)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(-2, h + 1, (b, h * w)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((b, h, w)).astype(np.float32)).to(dev)
    before = W.splat_cuda.launches
    xs, ys = x.clone().requires_grad_(), y.clone().requires_grad_()
    got = W.splat_mm(xs, ys, h, w)
    got.backward(g)
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    want = W.splat_reference(xr, yr, h, w)
    want.backward(g)
    torch.cuda.synchronize()
    assert W.splat_cuda.launches == before + 1
    assert _rel(got.detach(), want.detach()) <= ATOMIC_RTOL
    assert int(((got > 0.95) != (want > 0.95)).sum()) == 0
    assert (xs.grad - xr.grad).abs().max().item() <= WARP_TOL
    assert (ys.grad - yr.grad).abs().max().item() <= WARP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradient_matches_plain(dtype):
    """The kernel path's qkv gradient equals the plain path's autograd."""
    dev = _card()
    rng = np.random.default_rng(11)
    b, n, heads = 2, 97, 6
    c = heads * 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(dev)
    x = qkv.to(dtype).requires_grad_()
    out = qkv_attention(x, heads)
    assert out.grad_fn is not None
    out.float().backward(g)
    xr = qkv.to(dtype).float().requires_grad_()
    want = attention_reference(*(xr[..., i * c:(i + 1) * c].reshape(b, n, heads, 64)
                                 for i in range(3)), 0.125).reshape(b, n, c)
    want.backward(g)
    torch.cuda.synchronize()
    assert (x.grad.float() - xr.grad).abs().max().item() <= TOL[dtype] * 10


@pytest.mark.cuda
def test_qkv_projection_weight_gradient_through_kernel():
    """Gradients of a qkv projection's weight through the kernel path match
    the plain path's: a wrapper that cut its result off from autograd
    would leave this weight without a gradient."""
    from endodav_tpu_torch.ops.attention import fused_qkv_attention

    dev = _card()
    rng = np.random.default_rng(12)
    c, heads = 384, 6
    x = torch.from_numpy(rng.standard_normal((2, 50, c)).astype(np.float32)).to(dev)
    w0 = torch.from_numpy((rng.standard_normal((3 * c, c)) * c ** -0.5).astype(np.float32))
    grads = []
    for device in (dev, torch.device("cpu")):
        w = w0.to(device).requires_grad_()
        bias = torch.zeros(3 * c, device=device, requires_grad=True)
        out = fused_qkv_attention(x.to(device), w, bias, heads)
        (out * out).sum().backward()
        grads.append(w.grad.cpu())
    assert grads[0].abs().max() > 0
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-3 * grads[1].abs().max().item()


@pytest.mark.cuda
def test_fused_temporal_block_gradient_matches_plain():
    dev = _card()
    rng = np.random.default_rng(13)
    rows, t, c = 7, 8, 64
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    args = [f(rows, t, c, sd=0.5), 1.0 + f(c), f(c), f(t, c), *(f(c, c, sd=c ** -0.5)
                                                                for _ in range(4)), f(c)]
    g = f(rows, t, c, sd=1.0)
    got_in = [a.clone().requires_grad_() for a in args]
    out = fused_temporal_block(*got_in, 8)
    assert out.grad_fn is not None
    out.backward(g)
    ref_in = [a.clone().requires_grad_() for a in args]
    reference_block(*ref_in, 8).backward(g)
    torch.cuda.synchronize()
    for a, r in zip(got_in, ref_in):
        assert (a.grad - r.grad).abs().max().item() <= 1e-4 * max(1.0, r.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t,c", [(5, 32, 1024), (3, 7, 1024), (9, 5, 512)])
def test_grouped_temporal_block_matches_plain(dtype, rows, t, c):
    """C >= 512 launches the head-grouped kernel (and not the block kernel)."""
    from endodav_tpu_torch.kernels.fused_temporal_block import (grouped_reference_block,
                                                                 launch_grouped)

    dev = _card()
    rng = np.random.default_rng(rows * c + t)
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x = f(rows, t, c, sd=0.5)
    gamma, beta, pe = 1.0 + f(c), f(c), f(t, c)
    ws = [f(c, c, sd=c ** -0.5) for _ in range(4)]
    args = [a.to(dtype) for a in (x, *ws, f(c))]
    want = grouped_reference_block(args[0].float(), gamma, beta, pe,
                                   *(a.float() for a in args[1:5]), args[5].float(), 8)
    before = (launch_grouped.launches, fused_temporal_block.launches)
    got = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    again = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    torch.cuda.synchronize()
    assert (launch_grouped.launches, fused_temporal_block.launches) == (before[0] + 2, before[1])
    assert got.dtype == dtype and torch.equal(got, again)  # no atomics: the same bits
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_grouped_temporal_block_gradient_matches_plain():
    from endodav_tpu_torch.kernels.fused_temporal_block import grouped_reference_block

    dev = _card()
    rng = np.random.default_rng(14)
    rows, t, c = 3, 8, 512
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    args = [f(rows, t, c, sd=0.5), 1.0 + f(c), f(c), f(t, c), *(f(c, c, sd=c ** -0.5)
                                                                for _ in range(4)), f(c)]
    g = f(rows, t, c, sd=1.0)
    got_in = [a.clone().requires_grad_() for a in args]
    fused_temporal_block(*got_in, 8).backward(g)
    ref_in = [a.clone().requires_grad_() for a in args]
    grouped_reference_block(*ref_in, 8).backward(g)
    torch.cuda.synchronize()
    for a, r in zip(got_in, ref_in):
        assert (a.grad - r.grad).abs().max().item() <= 1e-4 * max(1.0, r.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,h", [(37, 384, 1536), (600, 1024, 4096), (8, 64, 256)])
def test_fused_mlp_matches_plain(dtype, rows, c, h):
    from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_reference

    dev = _card()
    rng = np.random.default_rng(rows + c)
    f = lambda *s, sd=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x, w1, b1, w2, b2 = f(rows, c), f(c, h, sd=c ** -0.5), f(h, sd=0.1), f(h, c, sd=h ** -0.5), \
        f(c, sd=0.1)
    xd, w1d, w2d = x.to(dtype), w1.to(dtype), w2.to(dtype)
    want = mlp_reference(xd, w1d, b1, w2d, b2).float()
    before = fused_mlp.launches
    got = fused_mlp(xd, w1d, b1, w2d, b2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max())


@pytest.mark.cuda
def test_int8_dense_product_is_exact():
    """torch._int_mm's int32 product equals the plain int64 one, and
    `int8_dense` refuses shapes it cannot take."""
    from endodav_tpu_torch.ops.quant import int8_dense, int_matmul, quantize_rows, quantize_weight

    dev = _card()
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((3, 50, 256)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((96, 256)) * 0.1).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32)).to(dev)
    x8, xs = quantize_rows(x)
    w8, ws = quantize_weight(w)
    acc = int_matmul(x8.reshape(-1, 256), w8)
    assert torch.equal(acc.cpu().long(), int_matmul(x8.reshape(-1, 256).cpu(), w8.cpu()))
    want = acc.float().reshape(3, 50, 96) * xs * ws + b
    torch.testing.assert_close(int8_dense(x, w, b), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="M > 16"):
        int8_dense(x[:1, :10], w, b)
