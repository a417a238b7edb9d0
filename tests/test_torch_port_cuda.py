"""The port's CUDA kernels against their plain versions on a CUDA card.

Marked `cuda`; each test skips without a card (the kernels have no CPU
mode).  The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

No test sets PyTorch's TF32 switches for the process: the plain versions
that run cuDNN convolutions do so inside a local `ieee_convs()` context,
and the whole-model test starts from PyTorch's defaults so that the entry
point's own f32 policy is what it holds.
"""

import contextlib

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
    return torch.device("cuda")


def ieee_convs():
    """cuDNN's f32 convolutions in IEEE f32 (TF32 off) for the block only."""
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                      benchmark=torch.backends.cudnn.benchmark,
                                      deterministic=torch.backends.cudnn.deterministic,
                                      allow_tf32=False)


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


def _warp_case(rng, b, tile, c, h, w, out_hw, disp=0.0):
    """img [b, h, w, c], coordinates [b * tile, *out_hw] and a cotangent.
    Without ``disp`` the coordinates are uniform over the image and a few
    pixels past every border; with it they follow the output grid's pixels
    (the training step's warps) plus 1.5 px of noise, and in the left half
    of the grid up to +-disp px, so some tiles' d_img boxes overflow."""
    n = b * tile
    img = rng.uniform(0, 1, (b, h, w, c))
    if disp:
        yy, xx = np.meshgrid(np.arange(out_hw[0]), np.arange(out_hw[1]), indexing="ij")
        wild = disp * (xx < out_hw[1] // 2)
        fx = xx + rng.normal(0, 1.5, (n, *out_hw)) + wild * rng.uniform(-1, 1, (n, *out_hw))
        fy = yy + rng.normal(0, 1.5, (n, *out_hw)) + wild * rng.uniform(-1, 1, (n, *out_hw))
    else:
        fx = rng.uniform(-3, w + 2, (n, *out_hw))
        fy = rng.uniform(-3, h + 2, (n, *out_hw))
    g = rng.standard_normal((n, *out_hw, c))
    return (torch.from_numpy(a.astype(np.float32)).to(_card()) for a in (img, fx, fy, g))


# (C, zeros mode, img_tile, image gradient, image [h, w], output grid,
# +-displacement, channel planes): 11x13 and 20x36 grids (P % 4 != 0, and
# 36 columns: a ragged forward tile), a 256x320 depth-warp case whose
# left-half displacements send some tiles of the fused backward to global
# atomics, colour synthesis at 256x320 (img_tile 4, 16-byte accesses), and
# the plane layout
WARP_CASES = [(3, False, 4, False, (37, 53), (11, 13), 0.0, False),
              (1, True, 1, True, (37, 53), (11, 13), 0.0, False),
              (2, False, 1, True, (37, 53), (11, 13), 0.0, False),
              (4, True, 2, False, (37, 53), (11, 13), 0.0, False),
              (2, True, 1, True, (30, 41), (20, 36), 0.0, False),
              (1, True, 1, True, (256, 320), (256, 320), 40.0, False),
              (3, False, 4, False, (256, 320), (256, 320), 6.0, False),
              (3, True, 1, True, (64, 96), (64, 96), 40.0, True),
              (2, False, 2, False, (37, 53), (11, 13), 0.0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,zeros,tile,img_grad,hw,out_hw,disp,cp", WARP_CASES)
def test_grid_sample_kernels_match_plain(monkeypatch, c, zeros, tile, img_grad, hw, out_hw, disp,
                                         cp):
    monkeypatch.setenv("ENDODAV_WARP_CP", "1" if cp else "0")
    rng = np.random.default_rng(c * 10 + tile)
    b = 2 if hw[0] > 100 else 3
    img, fx, fy, g = _warp_case(rng, b, tile, c, *hw, out_hw, disp)

    def run(fn):
        i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
        out = fn(i if img_grad else i.detach(), x, y)
        out.backward(g)
        return out.detach(), (i.grad if img_grad else None), x.grad, y.grad

    fns = ((W.grid_sample_fwd_cp_cuda, W.grid_sample_bwd_coord_cp_cuda,
            W.grid_sample_bwd_fused_cp_cuda) if cp else
           (W.grid_sample_fwd_cuda, W.grid_sample_bwd_coord_cuda, W.grid_sample_bwd_fused_cuda))
    counts = [f.launches for f in fns]
    got = run(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile))
    want = run(lambda i, x, y: W.grid_sample_reference(i, x, y, zeros, tile))
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, counts)] == [1, int(not img_grad), int(img_grad)]
    for k in (0, 2, 3):
        assert (got[k] - want[k]).abs().max().item() <= WARP_TOL
    if img_grad:
        assert _rel(got[1], want[1]) <= ATOMIC_RTOL
        share = W.tile_fit_share(fx, fy, *hw, c)
        fused = fns[2]
        assert fused.global_blocks() == round((1 - share) * fused.last_tiles)
        if disp > 6:  # both branches
            assert 0 < fused.global_blocks() < fused.last_tiles


@pytest.mark.cuda
@pytest.mark.parametrize("disp,planes", [(2.0, False), (40.0, False), (40.0, True)])
def test_fused_backward_counts_global_tiles(disp, planes):
    """The fused backward's count of tiles that took global atomics: 0 when
    every d_img box fits shared memory (displacements of a few pixels),
    positive with +-40 px in half the grid, and the plain box rule's count
    either way; d_img against the plain tiled decomposition."""
    rng = np.random.default_rng(int(disp) + planes)
    h, w = 128, 160
    img, fx, fy, g = _warp_case(rng, 4, 1, 1, h, w, (h, w), disp)
    src = W.to_planes(img) if planes else img
    fused = W.grid_sample_bwd_fused_cp_cuda if planes else W.grid_sample_bwd_fused_cuda
    dimg, dfx, dfy = fused(src, fx, fy, g, True)
    tiles = 4 * (h // 32) * (w // 32)
    assert fused.last_tiles == tiles
    want = W.bwd_tiled_reference(src, fx, fy, g, True, planes)
    assert fused.global_blocks() == round((1 - want[3]) * tiles)
    assert (fused.global_blocks() == 0) == (disp < 6)
    assert _rel(dimg, want[0]) <= ATOMIC_RTOL
    assert (dfx - want[1]).abs().max().item() <= WARP_TOL
    assert (dfy - want[2]).abs().max().item() <= WARP_TOL


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


def _splat_raster(rng, b, h, w, disp=0.0):
    """Coordinates [b, h * w] of a raster source on an h x w map: the pixel
    grid plus 1.5 px of noise and, in the left half, up to +-disp px."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    wild = disp * (xx < w // 2)
    x = xx + rng.normal(0, 1.5, (b, h, w)) + wild * rng.uniform(-1, 1, (b, h, w))
    y = yy + rng.normal(0, 1.5, (b, h, w)) + wild * rng.uniform(-1, 1, (b, h, w))
    return x.reshape(b, -1), y.reshape(b, -1)


# (map [h, w], source pixels P or None for a raster source of h x w,
# displacement): a raster moved by a small flow, a raster whose left half
# scatters by up to +-40 px on a 75-column grid, and P != H * W
SPLAT_CASES = [((64, 96), None, 0.0), ((70, 75), None, 40.0), ((40, 50), 3001, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,p,disp", SPLAT_CASES)
def test_splat_matches_plain_on_rasters_and_scatter(hw, p, disp):
    """The splat kernel on the coordinates its callers send (a raster moved
    by a flow) and on scattered ones: the map against the plain version,
    no 0.95 flips, one launch a call."""
    dev = _card()
    rng = np.random.default_rng(hw[0] + int(disp))
    h, w = hw
    b = 3
    if p is None:
        x, y = _splat_raster(rng, b, h, w, disp)
    else:
        x, y = rng.uniform(-2, w + 1, (b, p)), rng.uniform(-2, h + 1, (b, p))
    x, y = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, y))
    before = W.splat_cuda.launches
    got = W.splat_mm(x, y, h, w)
    assert W.splat_cuda.launches == before + 1
    want = W.splat_reference(x, y, h, w)
    assert _rel(got, want) <= ATOMIC_RTOL
    assert int(((got > 0.95) != (want > 0.95)).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("c,tile,out_hw", [(3, 4, (20, 50)), (3, 3, (11, 13)), (3, 5, (21, 36)),
                                           (3, 1, (33, 64)), (4, 2, (20, 50))])
def test_plane_forward_at_three_channels_and_more(c, tile, out_hw):
    """The plane forward at C >= 3, where a block walks the img_tile grid
    elements of one image (blockIdx.y the image): grids whose rows do not
    fill the last 32-column tile (50, 13, 36 columns), outputs of grids
    that start off a 16-byte boundary (11 x 13 and 21 x 36 pixels of 3
    floats), img_tile 1 to 5; against the planes' plain version and the
    interleaved kernel."""
    dev = _card()
    rng = np.random.default_rng(c * 100 + tile)
    b, h, w = 3, 37, 53
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)).to(dev)
    fx = torch.from_numpy(rng.uniform(-3, w + 2, (b * tile, *out_hw)).astype(np.float32)).to(dev)
    fy = torch.from_numpy(rng.uniform(-3, h + 2, (b * tile, *out_hw)).astype(np.float32)).to(dev)
    planes = W.to_planes(img)
    before = W.grid_sample_fwd_cp_cuda.launches
    got = W.grid_sample_fwd_cp_cuda(planes, fx, fy, False, tile)
    torch.cuda.synchronize()
    assert W.grid_sample_fwd_cp_cuda.launches == before + 1
    for want in (W.grid_sample_planes_reference(planes, fx, fy, False, tile),
                 W.grid_sample_fwd_cuda(img, fx, fy, False, tile)):
        assert (got - want).abs().max().item() <= WARP_TOL


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
    """C >= 512: the tensor-core route, one launch counted a call, the same
    bits twice."""
    from endodav_tpu_torch.kernels.fused_temporal_block import grouped_reference_block

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
    before = fused_temporal_block.launches
    got = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    again = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 2
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 63, 437, 1702])
def test_grouped_block_tensor_cores_at_row_counts(dtype, rows):
    """vitl's motion modules (C=1024, T=32, 8 heads of 128) on the two
    tensor-core launches, at row counts that no 128-token tile divides and
    at a 518x644 window's, against the grouped plain version at TOL; the
    weights as the motion modules pass them (`lin.weight.t()` views) give
    the same bits as contiguous JAX-layout copies."""
    from endodav_tpu_torch.kernels.fused_temporal_block import grouped_reference_block

    dev = _card()
    t, c = 32, 1024
    rng = np.random.default_rng(rows)
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x = f(rows, t, c, sd=0.5).to(dtype)
    gamma, beta, pe = 1.0 + f(c, sd=0.1), f(c, sd=0.1), f(t, c)
    torch_layout = [f(c, c, sd=c ** -0.5).to(dtype) for _ in range(4)]  # [C_out, C_in]
    ws = [w.t() for w in torch_layout]
    bo = f(c, sd=0.1).to(dtype)
    want = grouped_reference_block(x.float(), gamma, beta, pe, *(w.float() for w in ws),
                                   bo.float(), 8)
    before = fused_temporal_block.launches
    got = fused_temporal_block(x, gamma, beta, pe, *ws, bo, 8)
    copies = fused_temporal_block(x, gamma, beta, pe, *(w.contiguous() for w in ws), bo, 8)
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 2 and got.dtype == dtype
    assert torch.equal(got, copies)
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 127, 54496])
@pytest.mark.parametrize("c,h", [(384, 1536), (1024, 4096)])
def test_fused_mlp_tensor_cores_at_row_counts(dtype, rows, c, h):
    """vits widths (C2=384: one CTA) and vitl widths (C2=1024: a cluster of
    4 CTAs) at row counts that no row tile divides and at a 32-frame
    518x644 encode batch, weights as `Mlp` passes them (`lin.weight.t()`):
    the plain version at TOL of max(1, the largest entry), the planes made
    once (a second call hits the cache and gives the same bits)."""
    from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_reference

    dev = _card()
    rng = np.random.default_rng(rows + c)
    f = lambda *s, sd=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x = f(rows, c).to(dtype)
    fc1, fc2 = f(h, c, sd=c ** -0.5).to(dtype), f(c, h, sd=h ** -0.5).to(dtype)
    b1, b2 = f(h, sd=0.1), f(c, sd=0.1)
    want = mlp_reference(x, fc1.t(), b1, fc2.t(), b2).float()
    before, misses = fused_mlp.launches, fused_mlp.planes.misses
    got = fused_mlp(x, fc1.t(), b1, fc2.t(), b2)
    again = fused_mlp(x, fc1.t(), b1, fc2.t(), b2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 2 and got.dtype == dtype and torch.equal(got, again)
    assert fused_mlp.planes.misses == misses + (2 if dtype == torch.float32 else 0)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [(2, 16, 24, 64), (1, 10, 24, 64), (1, 6, 16, 64),
                                     (2, 9, 8, 128), (1, 19, 23, 64), (1, 3, 5, 32)])
def test_fused_rcu_matches_plain(dtype, b, h, w, c):
    """Tiles on every border, frames smaller than one 8x16 tile, C=128."""
    from endodav_tpu_torch.kernels.fused_rcu import fused_rcu, rcu_reference

    dev = _card()
    rng = np.random.default_rng(b * h * w + c)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dev).to(dtype)
    convs = [torch.nn.Conv2d(c, c, 3, padding=1).to(dev) for _ in range(2)]
    with torch.no_grad():
        for conv in convs:
            conv.weight.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(conv.weight.shape)) * (9 * c) ** -0.5)
                .astype(np.float32)))
        wq = [conv.weight.to(dtype).float() for conv in convs]
        with ieee_convs():
            want = rcu_reference(x.float(), wq[0], convs[0].bias, wq[1], convs[1].bias)
        before = fused_rcu.launches
        got = fused_rcu(x, *convs)
    torch.cuda.synchronize()
    assert fused_rcu.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max())


@pytest.mark.cuda
def test_fused_rcu_gradient_matches_plain():
    from endodav_tpu_torch.kernels.fused_rcu import fused_rcu, rcu_reference

    dev = _card()
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((1, 9, 20, 64)).astype(np.float32)).to(dev)
    convs = [torch.nn.Conv2d(64, 64, 3, padding=1).to(dev) for _ in range(2)]
    xs = x.clone().requires_grad_()
    xr = x.clone().requires_grad_()
    params = [p.detach().clone().requires_grad_() for conv in convs for p in conv.parameters()]
    with ieee_convs():  # the kernel's backward recomputes its plain version's convolutions
        out = fused_rcu(xs, *convs)
        assert out.grad_fn is not None
        (out ** 2).sum().backward()
        (rcu_reference(xr, *params) ** 2).sum().backward()
    got = [xs.grad] + [p.grad for conv in convs for p in conv.parameters()]
    for a, r in zip(got, [xr.grad] + [p.grad for p in params]):
        assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t,heads,dh", [(13, 32, 8, 8), (7, 16, 8, 24), (5, 32, 8, 48),
                                             (3, 32, 8, 128), (2, 64, 4, 16), (1, 5, 2, 3)])
def test_temporal_attention_matches_plain(dtype, rows, t, heads, dh):
    from endodav_tpu_torch.kernels.temporal_attention import (temporal_attention,
                                                              temporal_attention_reference)

    dev = _card()
    rng = np.random.default_rng(rows * t + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((rows, t, heads, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    want = temporal_attention_reference(q.float(), k.float(), v.float(), dh ** -0.5)
    before = temporal_attention.launches
    got = temporal_attention(q, k, v)
    torch.cuda.synchronize()
    assert temporal_attention.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_temporal_attention_gradient_matches_plain():
    from endodav_tpu_torch.kernels.temporal_attention import (temporal_attention,
                                                              temporal_attention_reference)

    dev = _card()
    rng = np.random.default_rng(22)
    qkv = [torch.from_numpy(rng.standard_normal((11, 16, 8, 24)).astype(np.float32)).to(dev)
           for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((11, 16, 8, 24)).astype(np.float32)).to(dev)
    got_in = [a.clone().requires_grad_() for a in qkv]
    temporal_attention(*got_in).backward(g)
    ref_in = [a.clone().requires_grad_() for a in qkv]
    temporal_attention_reference(*ref_in, 24 ** -0.5).backward(g)
    torch.cuda.synchronize()
    for a, r in zip(got_in, ref_in):
        assert (a.grad - r.grad).abs().max().item() <= 1e-4 * max(1.0, r.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c,zeros,tile,img_grad", [(3, False, 4, False), (2, False, 1, True),
                                                   (4, True, 1, True), (3, True, 2, False)])
def test_channel_plane_kernels_match_plain_and_interleaved(monkeypatch, c, zeros, tile,
                                                           img_grad):
    """ENDODAV_WARP_CP=1: the plane kernels launch (and not the interleaved
    ones) and agree with the planes' plain version and the interleaved
    kernels."""
    dev = _card()
    rng = np.random.default_rng(c * 10 + tile + 7)
    b, h, w = 3, 37, 53
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)).to(dev)
    fx = torch.from_numpy(rng.uniform(-3, w + 2, (b * tile, 11, 13)).astype(np.float32)).to(dev)
    fy = torch.from_numpy(rng.uniform(-3, h + 2, (b * tile, 11, 13)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((b * tile, 11, 13, c)).astype(np.float32)).to(dev)

    def run(fn, cp):
        monkeypatch.setenv("ENDODAV_WARP_CP", "1" if cp else "0")
        i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
        out = fn(i if img_grad else i.detach(), x, y)
        out.backward(g)
        return out.detach(), (i.grad if img_grad else None), x.grad, y.grad

    fns = (W.grid_sample_fwd_cp_cuda, W.grid_sample_bwd_coord_cp_cuda,
           W.grid_sample_bwd_fused_cp_cuda, W.grid_sample_fwd_cuda)
    counts = [f.launches for f in fns]
    got = run(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile), True)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, counts)] == [1, int(not img_grad), int(img_grad), 0]
    plain = run(lambda i, x, y: W.grid_sample_planes_reference(W.to_planes(i), x, y, zeros, tile),
                True)
    inter = run(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile), False)
    torch.cuda.synchronize()
    for want in (plain, inter):
        for k in (0, 2, 3):
            assert (got[k] - want[k]).abs().max().item() <= WARP_TOL
        if img_grad:
            assert _rel(got[1], want[1]) <= ATOMIC_RTOL


@pytest.mark.cuda
def test_cli_model_path_holds_f32_without_a_global_switch():
    """The CLI's model path (`build_depth_model` with the CLI's defaults:
    vits, 224x280, unmerged dvlora) on the card against the CPU at 2e-4,
    starting from PyTorch's defaults (cuDNN convolutions in TF32) inside a
    local context: only the entry point's own f32 policy turns TF32 off."""
    import copy

    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.options import EndoDAVOptions

    dev = _card()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=True):
        cpu_model = engine.build_depth_model(EndoDAVOptions().parse(["--no_cuda"]),
                                             torch.device("cpu"))
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        rng = np.random.default_rng(0)
        video = torch.from_numpy(rng.uniform(0.0, 1.0, (1, 8, 256, 320, 3)).astype(np.float32))
        with torch.inference_mode():
            want = cpu_model(video)
            got = gpu_model(video.to(dev))
        for s in range(4):
            err = (got[("disp", s)].cpu() - want[("disp", s)]).abs().max().item()
            assert np.isfinite(err) and err <= 2e-4, (s, err)


def _block_args(dev, rows, t, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    return [f(rows, t, c, sd=0.5), 1.0 + f(c, sd=0.1), f(c, sd=0.1), f(t, c),
            *(f(c, c, sd=c ** -0.5) for _ in range(4)), f(c, sd=0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [5, 8, 32])
@pytest.mark.parametrize("c", [64, 192, 256, 384])
def test_temporal_block_below_512_on_the_tensor_cores(dtype, t, c):
    """The C < 512 widths on the tensor-core route at 37 rows (a partial
    last token tile at every T), against the plain version in its order
    (`grouped_reference_block`) at TOL; one launch counted a call."""
    from endodav_tpu_torch.kernels.fused_temporal_block import grouped_reference_block

    dev = _card()
    x, gamma, beta, pe, *ws, bo = _block_args(dev, 37, t, c, c + t)
    args = [a.to(dtype) for a in (x, *ws, bo)]
    want = grouped_reference_block(args[0].float(), gamma, beta, pe,
                                   *(a.float() for a in args[1:5]), args[5].float(), 8)
    before = fused_temporal_block.launches
    got = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 192, 256, 384])
def test_temporal_block_below_512_gradient_matches_plain(c):
    from endodav_tpu_torch.kernels.fused_temporal_block import grouped_reference_block

    dev = _card()
    args = _block_args(dev, 37, 8, c, c + 1)
    g = torch.from_numpy(np.random.default_rng(c).standard_normal((37, 8, c))
                         .astype(np.float32)).to(dev)
    got_in = [a.clone().requires_grad_() for a in args]
    out = fused_temporal_block(*got_in, 8)
    assert out.grad_fn is not None
    out.backward(g)
    ref_in = [a.clone().requires_grad_() for a in args]
    grouped_reference_block(*ref_in, 8).backward(g)
    torch.cuda.synchronize()
    for a, r in zip(got_in, ref_in):
        assert (a.grad - r.grad).abs().max().item() <= 1e-4 * max(1.0, r.grad.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 16, 32, 64])
@pytest.mark.parametrize("dh", [8, 24, 32, 48, 128])
def test_temporal_attention_warp_per_head_at_model_widths(dtype, t, dh):
    """Every head width of the models' motion modules at T from 1 to 64,
    37 rows of 8 heads, against the plain version at TOL, and its
    gradient (f32)."""
    from endodav_tpu_torch.kernels.temporal_attention import (temporal_attention,
                                                              temporal_attention_reference)

    dev = _card()
    rng = np.random.default_rng(t * 1000 + dh)
    qkv = [torch.from_numpy(rng.standard_normal((37, t, 8, dh)).astype(np.float32)).to(dev)
           for _ in range(3)]
    q, k, v = (a.to(dtype) for a in qkv)
    want = temporal_attention_reference(q.float(), k.float(), v.float(), dh ** -0.5)
    before = temporal_attention.launches
    got = temporal_attention(q, k, v)
    torch.cuda.synchronize()
    assert temporal_attention.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]
    if dtype == torch.float32:
        cot = torch.from_numpy(rng.standard_normal((37, t, 8, dh)).astype(np.float32)).to(dev)
        got_in = [a.clone().requires_grad_() for a in qkv]
        temporal_attention(*got_in).backward(cot)
        ref_in = [a.clone().requires_grad_() for a in qkv]
        temporal_attention_reference(*ref_in, dh ** -0.5).backward(cot)
        for a, r in zip(got_in, ref_in):
            assert ((a.grad - r.grad).abs().max().item()
                    <= 1e-4 * max(1.0, r.grad.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 1024, 4096])
def test_tile_promoted_order_within_half_the_f32_tolerance(k):
    """The 3xTF32 tile in the kernels' accumulation order (a partial of
    two k-steps promoted into the running sum) against a float64 product,
    on signed and on same-sign operands: within half the f32 tolerance of
    max(1, |ref|) up to fc2's K = 4096."""
    from endodav_tpu_torch.bench.tile_error import tile_matmul

    dev = _card()
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.standard_normal((k, 128)) * k ** -0.5).astype(np.float32)).to(dev)
    for x, y in ((a, b), (a.abs(), b.abs())):
        ref = x.double() @ y.double()
        err = (tile_matmul(x, y).double() - ref).abs().max().item()
        assert err <= TOL[torch.float32] / 2 * max(1.0, ref.abs().max().item())


def _attention64(qkv, heads):
    """Attention of a packed [B, N, 3C] qkv in float64, [B, N, C]."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (qkv.double()[..., i * c:(i + 1) * c].reshape(b, n, heads, -1) for i in range(3))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * (c // heads) ** -0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [321, 1703])
@pytest.mark.parametrize("heads", [6, 16])
def test_flash_attention_tensor_cores_at_model_shapes(dtype, n, heads):
    """The tensor-core kernel at the ViT's token counts (N=321 ends in a
    one-key tile, 1703 = 26*64 + 39) and head counts (vits 6, vitl 16)
    against its plain version, one launch a call; f32 also within a tenth
    of its tolerance of float64 (the partials' accumulation order)."""
    dev = _card()
    b, c = 2, heads * 64
    rng = np.random.default_rng(n + heads)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32)).to(dev)
    qkv = qkv.to(dtype)
    want = attention_reference(*(qkv.float()[..., i * c:(i + 1) * c].reshape(b, n, heads, 64)
                                 for i in range(3)), 0.125).reshape(b, n, c)
    before = qkv_attention.launches
    got = qkv_attention(qkv, heads)
    torch.cuda.synchronize()
    assert qkv_attention.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]
    if dtype == torch.float32:
        assert (got.double() - _attention64(qkv, heads)).abs().max().item() <= TOL[dtype] / 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_a_qkv_view_with_a_wider_row(dtype):
    """q, k and v read from a view whose row stride is above 3C (the
    projection's columns inside a wider buffer), as from a contiguous
    copy; a view the kernel cannot copy in 16-byte vectors raises."""
    dev = _card()
    b, n, heads = 2, 200, 6
    c = heads * 64
    rng = np.random.default_rng(9)
    wide = torch.from_numpy(rng.standard_normal((b, n, 3 * c + 64)).astype(np.float32))
    wide = wide.to(dev).to(dtype)
    view = wide[..., 32:32 + 3 * c]
    assert view.stride(1) == 3 * c + 64
    got = qkv_attention(view, heads)
    want = qkv_attention(view.contiguous(), heads)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() == 0.0
    with pytest.raises(ValueError, match="16-byte"):
        qkv_attention(wide[..., 1:1 + 3 * c], heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(19, 23, 64), (37, 46, 64), (74, 92, 64), (148, 184, 64),
                                   (64, 80, 64), (13, 21, 4), (9, 17, 36), (10, 30, 128)])
def test_fused_rcu_tensor_cores_at_head_shapes(dtype, h, w, c):
    """The implicit-GEMM kernel at the vits head's RCU sizes (two frames of
    each), at C=4 and 36 (channels zero-padded to 16 and 64 in the kernel)
    and C=128, against its plain version, one launch a call; the second
    call reuses the weights' tap planes."""
    from endodav_tpu_torch.kernels.fused_rcu import fused_rcu, rcu_reference

    dev = _card()
    rng = np.random.default_rng(h * w + c)
    x = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(dev).to(dtype)
    convs = [torch.nn.Conv2d(c, c, 3, padding=1).to(dev) for _ in range(2)]
    with torch.no_grad():
        for conv in convs:
            conv.weight.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(conv.weight.shape)) * (9 * c) ** -0.5)
                .astype(np.float32)))
        wq = [conv.weight.to(dtype).float() for conv in convs]
        with ieee_convs():
            want = rcu_reference(x.float(), wq[0], convs[0].bias, wq[1], convs[1].bias)
        before = fused_rcu.launches
        got = fused_rcu(x, *convs)
        hits = fused_rcu.planes.hits
        again = fused_rcu(x, *convs)
    torch.cuda.synchronize()
    assert fused_rcu.launches == before + 2 and got.dtype == dtype
    assert fused_rcu.planes.hits == hits + 2 and torch.equal(got, again)
    assert (got.float() - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max())


# bf16 serving, card (kernels) against the CPU (plain versions).  At the
# engine's seed weights the disparity spans nearly [0, 1] and bf16 moves
# pixels in the sigmoids' steep part: JAX's own bf16 error against its f32
# there is up to 5.9e-2 max (tools/bf16_reference_error.py), above the
# whole-model bf16 bound of tests/test_torch_bf16_serving.py (2.5e-2, set
# at JAX's init weights).  So the card's bf16 is held, against the CPU's
# f32, to the CPU bf16 plain version's own error on the same weights and
# frames: the mean within 1.5x (that test's relative bound), the largest
# within 2x (a maximum over one clip varies more); as chip_smoke.py does.
BF16_REL_MAX, BF16_REL_MEAN = 2.0, 1.5


def _bf16_models(dev, args=(), **changes):
    """A seeded model through `build_depth_model` on the CPU (f32), its bf16
    clone there and a copy of that on the card."""
    import copy

    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.options import EndoDAVOptions

    opt = EndoDAVOptions().parse(["--no_cuda", "--depth_image_shape", "112", "140", *args])
    f32 = engine.build_depth_model(opt, torch.device("cpu"))
    if changes:
        f32 = f32.clone(**changes)
    plain = f32.clone(dtype=torch.bfloat16)
    return f32, plain, copy.deepcopy(plain).to(dev)


def _err(a, b):
    d = (torch.as_tensor(a).float().cpu() - torch.as_tensor(b).float().cpu()).abs()
    assert torch.isfinite(d).all()
    return d.max().item(), d.mean().item()


def _bf16_close(card, plain, f32):
    """The card's bf16 against f32 within BF16_REL_MAX / BF16_REL_MEAN times
    the CPU bf16 plain version's own error."""
    got, own = _err(card, f32), _err(plain, f32)
    assert got[0] <= BF16_REL_MAX * own[0] and got[1] <= BF16_REL_MEAN * own[1], (got, own)


@pytest.mark.cuda
@pytest.mark.parametrize("route,args,env,changes", [
    ("flash_attention", (), {}, {}),
    ("fused_rcu", (), {"ENDODAV_FUSED_RCU": "1"}, {}),
    ("fused_mlp", ("--merge_lora",), {"ENDODAV_FUSED_MLP": "1"}, {}),
    ("temporal_attention", (), {}, {"pos_embedding_type": "rope"}),
])
def test_bf16_model_on_the_card_matches_the_cpu(monkeypatch, route, args, env, changes):
    """The bf16 vits model (`clone(dtype=torch.bfloat16)` of the engine's
    seeded model) on the card against the CPU on one 4-frame clip, with
    the route's kernel launched at bf16: every scale in bf16, within the
    relative bound above."""
    from endodav_tpu_torch.kernels import flash_attention, fused_mlp, fused_rcu
    from endodav_tpu_torch.kernels import temporal_attention

    counters = {"flash_attention": flash_attention.qkv_attention, "fused_rcu": fused_rcu.fused_rcu,
                "fused_mlp": fused_mlp.fused_mlp,
                "temporal_attention": temporal_attention.temporal_attention}
    dev = _card()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    f32, plain, gpu = _bf16_models(dev, args, **changes)
    video = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 4, 128, 160, 3))
                             .astype(np.float32))
    with torch.inference_mode():
        want, own = f32(video), plain(video)
        before = counters[route].launches
        got = gpu(video.to(dev))
        launched = counters[route].launches - before
    assert launched > 0
    for s in range(4):
        assert got[("disp", s)].dtype == torch.bfloat16
        _bf16_close(got[("disp", s)], own[("disp", s)], want[("disp", s)])


@pytest.mark.cuda
@pytest.mark.parametrize("stitch,transfer,sequential", [
    ("device", np.float16, False),   # the TPU benchmark's headline leg
    ("host", np.float32, True),      # its baseline leg
])
def test_bf16_serving_options_on_the_card(stitch, transfer, sequential):
    """`infer_video_depth` with the bf16 model over 54 frames (3 windows),
    dedup where it serves, on the card against the CPU's bf16 and f32
    runs, within the relative bound above."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval import video_inference as tvi

    dev = _card()
    f32, plain, gpu = _bf16_models(dev, ("--merge_lora", "--disable_residual_block"))
    frames = np.random.default_rng(1).integers(0, 255, (54, 128, 160, 3), dtype=np.uint8)
    kw = dict(image_shape=(112, 140), chunk_windows=2, stitch=stitch, transfer_dtype=transfer,
              sequential=sequential)
    out = {}
    for name, model, device in (("f32", f32, torch.device("cpu")),
                                ("plain", plain, torch.device("cpu")), ("card", gpu, dev)):
        fwd = engine.depth_window_forward(model)
        dedup = None if sequential else tvi.DedupWindowForward(model)
        out[name] = tvi.infer_video_depth(fwd, frames, device=device, dedup=dedup, **kw)
    assert out["card"].dtype == out["plain"].dtype and out["card"].shape == (54, 128, 160)
    _bf16_close(out["card"], out["plain"], out["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 127, 8 * 321])
def test_fused_mlp_on_a_cluster_of_three(dtype, rows):
    """vitb's MLP (768 -> 3072 -> 768: the widest column tile on a cluster
    of 3 CTAs) at odd row counts and an EndoDAC batch of 8 224x280 frames,
    against its plain version at TOL of max(1, the largest entry)."""
    from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_reference

    dev = _card()
    c, h = 768, 3072
    rng = np.random.default_rng(rows)
    f = lambda *s, sd=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x = f(rows, c).to(dtype)
    fc1, fc2 = f(h, c, sd=c ** -0.5).to(dtype), f(c, h, sd=h ** -0.5).to(dtype)
    b1, b2 = f(h, sd=0.1), f(c, sd=0.1)
    want = mlp_reference(x, fc1.t(), b1, fc2.t(), b2).float()
    before = fused_mlp.launches
    got = fused_mlp(x, fc1.t(), b1, fc2.t(), b2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype] * max(1.0, want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [6, 12])
def test_flash_attention_at_endodac_batches(dtype, heads):
    """An EndoDAC batch of 8 224x280 frames (N=321) at vits (6 heads) and
    vitb (12 heads) against the plain version, one launch."""
    dev = _card()
    b, n, c = 8, 321, heads * 64
    rng = np.random.default_rng(heads)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32)).to(dev)
    qkv = qkv.to(dtype)
    want = attention_reference(*(qkv.float()[..., i * c:(i + 1) * c].reshape(b, n, heads, 64)
                                 for i in range(3)), 0.125).reshape(b, n, c)
    before = qkv_attention.launches
    got = qkv_attention(qkv, heads)
    torch.cuda.synchronize()
    assert qkv_attention.launches == before + 1
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("encoder,args,env,launches", [
    ("vits", [], {}, {"flash": 12, "mlp": 0, "rcu": 0}),
    ("vitb", [], {"ENDODAV_FUSED_RCU": "1"}, {"flash": 12, "mlp": 0, "rcu": 7}),
    ("vitb", ["--merge_lora"], {"ENDODAV_FUSED_MLP": "1"}, {"flash": 12, "mlp": 12, "rcu": 0}),
])
def test_endodac_on_the_card_matches_the_cpu(monkeypatch, encoder, args, env, launches):
    """EndoDAC through `build_depth_model` (plain LoRA, 224x280) on 4 frames:
    the card's four disparity scales within 2e-4 of the CPU's, with the
    kernels launched once a ViT block (flash, fused MLP) or an RCU."""
    import copy

    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.kernels.fused_mlp import fused_mlp
    from endodav_tpu_torch.kernels.fused_rcu import fused_rcu
    from endodav_tpu_torch.options import EndoDAVOptions

    dev = _card()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opt = EndoDAVOptions().parse(["--no_cuda", "--model_type", "endodac", "--lora_type", "lora",
                                  "--encoder", encoder, *args])
    cpu_model = engine.build_depth_model(opt, torch.device("cpu"))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    frames = torch.from_numpy(np.random.default_rng(1).uniform(0.0, 1.0, (4, 256, 320, 3))
                              .astype(np.float32))
    counts = {"flash": qkv_attention, "mlp": fused_mlp, "rcu": fused_rcu}
    before = {k: fn.launches for k, fn in counts.items()}
    with torch.inference_mode():
        got = gpu_model(frames.to(dev))
        assert {k: fn.launches - before[k] for k, fn in counts.items()} == launches
        want = cpu_model(frames)
    for s in range(4):
        err = (got[("disp", s)].cpu() - want[("disp", s)]).abs().max().item()
        assert np.isfinite(err) and err <= 2e-4, (s, err)
