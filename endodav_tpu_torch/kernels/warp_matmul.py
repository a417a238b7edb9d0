"""Bilinear grid-sample and forward-splat: the CUDA kernels, their plain
versions and the wrappers with their gradients.

Port of `endodav_tpu/kernels/warp_matmul.py` (`grid_sample_mm` with its
Pallas forward and its two backward kernels, and `splat_mm`).  The
functions are the 4-corner gather and the scatter-add of
`endodav_tpu/ops/sampling.py`; `csrc/warp.cu` computes them with one
thread per pixel (the TPU's one-hot matmuls existed only because a TPU
has no fast gather).

* `grid_sample_mm(img, fx, fy, ...)` samples img [B, H, W, C] at
  fractional pixel coordinates fx, fy [B * img_tile, *out] and returns
  [B * img_tile, *out, C] f32.  Its gradient is `_GridSample`: the
  backward kernel gives d_fx, d_fy and, with ``img_grad``, accumulates
  d_img with atomics (the fused kernel); without it the coordinate-only
  kernel runs and the image gets no gradient, as JAX's `_mm_bwd` does.
* `splat_mm(x, y, h, w)` spreads unit bilinear mass from pixel coords
  x, y [B, P] onto an occupancy map [B, h, w] f32.  Its backward
  recomputes the plain version's autograd, as JAX's `_splat_fast_bwd`.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
versions (`grid_sample_reference`, `splat_reference`) run only for CPU
tensors, where autograd differentiates them.  Each launching function
counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build

__all__ = ["grid_sample_mm", "splat_mm", "grid_sample_reference", "splat_reference",
           "grid_sample_fwd_cuda", "grid_sample_bwd_coord_cuda", "grid_sample_bwd_fused_cuda",
           "splat_cuda"]

MAX_CHANNELS = 4  # the kernels' channel loop is unrolled for C = 1..4


def _axis(f: torch.Tensor, size: int, zeros_mode: bool):
    """Clipped corner indices and (masked) lerp weights of one axis."""
    f0 = torch.floor(f)
    w1 = f - f0
    w0 = 1.0 - w1
    i0, i1 = f0, f0 + 1.0
    if zeros_mode:
        w0 = w0 * ((i0 >= 0) & (i0 <= size - 1))
        w1 = w1 * ((i1 >= 0) & (i1 <= size - 1))
    return (i0.clamp(0, size - 1).long(), i1.clamp(0, size - 1).long()), (w0, w1)


def grid_sample_reference(img, fx, fy, zeros_mode: bool, img_tile: int = 1):
    """Plain version: the 4-corner gather of `ops/sampling.py:grid_sample`
    (:114-134 of the JAX package) over img [B, H, W, C], fx/fy
    [B*img_tile, *out] -> [B*img_tile, *out, C]."""
    b_img, h, w, c = img.shape
    bg = fx.shape[0]
    out_sp = fx.shape[1:]
    flat = img.reshape(b_img, h * w, c)
    src = (torch.arange(bg, device=img.device) // img_tile)[:, None]
    (x0, x1), (wx0, wx1) = _axis(fx.reshape(bg, -1), w, zeros_mode)
    (y0, y1), (wy0, wy1) = _axis(fy.reshape(bg, -1), h, zeros_mode)
    out = 0.0
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            out = out + (wy * wx)[..., None] * flat[src, yi * w + xi]
    return out.reshape(bg, *out_sp, c)


def splat_reference(x, y, height: int, width: int):
    """Plain version: `_splat_xla` (ops/sampling.py:181-214 of the JAX
    package) as four `index_add_` scatters; x, y [B, P] -> [B, H, W]."""
    b = x.shape[0]
    x1, y1 = torch.floor(x), torch.floor(y)
    x0, y0 = x1 + 1, y1 + 1
    xf, yf = x1.clamp(0, width - 1), y1.clamp(0, height - 1)
    xc, yc = x0.clamp(0, width - 1), y0.clamp(0, height - 1)
    bad_xc, bad_yc, bad_xf, bad_yf = x0 != xc, y0 != yc, x1 != xf, y1 != yf
    base = (torch.arange(b, device=x.device) * (height * width))[:, None]
    out = torch.zeros(b * height * width, dtype=x.dtype, device=x.device)
    for cx, cy, bad in ((xc, yc, bad_xc | bad_yc), (xc, yf, bad_xc | bad_yf),
                        (xf, yc, bad_xf | bad_yc), (xf, yf, bad_xf | bad_yf)):
        # |d| with JAX's gradient at d == 0 (+1), as `_splat_fast_bwd` has it
        dx, dy = x - cx, y - cy
        val = (1.0 - torch.where(dx >= 0, dx, -dx)) * (1.0 - torch.where(dy >= 0, dy, -dy))
        val = torch.where(bad, torch.zeros_like(val), val)
        idx = (base + (cy * width + cx).long()).reshape(-1)
        out = out.index_add(0, idx, val.reshape(-1))
    return out.reshape(b, height, width)


def _require_cuda_f32(what: str, **tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _check_shapes(img, fx, fy, img_tile):
    b_img, h, w, c = img.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"grid_sample: C={c} channels; the kernels take 1..{MAX_CHANNELS}")
    if fx.shape != fy.shape or fx.shape[0] != b_img * img_tile:
        raise ValueError(f"grid_sample: coords {tuple(fx.shape)}/{tuple(fy.shape)} do not "
                         f"match {b_img} images x img_tile {img_tile}")
    return b_img, h, w, c


def grid_sample_fwd_cuda(img, fx, fy, zeros_mode: bool, img_tile: int = 1):
    """Launch the forward kernel; returns [Bg, *out, C] f32."""
    _require_cuda_f32("grid_sample", img=img, fx=fx, fy=fy)
    _, h, w, c = _check_shapes(img, fx, fy, img_tile)
    bg, p = fx.shape[0], fx[0].numel()
    out = torch.empty((*fx.shape, c), dtype=torch.float32, device=img.device)
    lib = _build.library()
    with torch.cuda.device(img.device):
        err = lib.endodav_grid_sample_fwd(img.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                                          out.data_ptr(), bg, p, h, w, c, img_tile,
                                          int(zeros_mode), _build.stream_of(img))
    _build.check(err, "grid_sample_fwd")
    grid_sample_fwd_cuda.launches += 1
    return out


def _launch_bwd(img, fx, fy, g, zeros_mode, img_tile, dimg):
    _require_cuda_f32("grid_sample backward", img=img, fx=fx, fy=fy, g=g)
    _, h, w, c = _check_shapes(img, fx, fy, img_tile)
    bg, p = fx.shape[0], fx[0].numel()
    dfx, dfy = torch.empty_like(fx), torch.empty_like(fy)
    lib = _build.library()
    with torch.cuda.device(img.device):
        err = lib.endodav_grid_sample_bwd(
            img.data_ptr(), fx.data_ptr(), fy.data_ptr(), g.data_ptr(), dfx.data_ptr(),
            dfy.data_ptr(), None if dimg is None else dimg.data_ptr(), bg, p, h, w, c,
            img_tile, int(zeros_mode), _build.stream_of(img))
    _build.check(err, "grid_sample_bwd")
    return dfx, dfy


def grid_sample_bwd_coord_cuda(img, fx, fy, g, zeros_mode: bool, img_tile: int = 1):
    """Coordinate-only backward (`_bwd_coord_kernel`): (d_fx, d_fy)."""
    out = _launch_bwd(img, fx, fy, g, zeros_mode, img_tile, None)
    grid_sample_bwd_coord_cuda.launches += 1
    return out


def grid_sample_bwd_fused_cuda(img, fx, fy, g, zeros_mode: bool):
    """Fused backward (`_bwd_fused_kernel`): (d_img, d_fx, d_fy); d_img is
    summed with atomics, so its last bits vary from run to run."""
    dimg = torch.zeros_like(img)
    dfx, dfy = _launch_bwd(img, fx, fy, g, zeros_mode, 1, dimg)
    grid_sample_bwd_fused_cuda.launches += 1
    return dimg, dfx, dfy


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, fx, fy, zeros_mode, img_grad, img_tile):
        ctx.save_for_backward(img, fx, fy)
        ctx.zeros_mode, ctx.img_grad, ctx.img_tile = zeros_mode, img_grad, img_tile
        return grid_sample_fwd_cuda(img, fx, fy, zeros_mode, img_tile)

    @staticmethod
    def backward(ctx, g):
        img, fx, fy = ctx.saved_tensors
        g = g.contiguous()
        if ctx.img_grad:
            dimg, dfx, dfy = grid_sample_bwd_fused_cuda(img, fx, fy, g, ctx.zeros_mode)
        else:  # the caller declared the image gradient-free
            dimg = None
            dfx, dfy = grid_sample_bwd_coord_cuda(img, fx, fy, g, ctx.zeros_mode, ctx.img_tile)
        return dimg, dfx, dfy, None, None, None


def grid_sample_mm(img, fx, fy, zeros_mode: bool = False, img_grad: bool = True,
                   img_tile: int = 1):
    """Bilinear sample img [B, H, W, C] at fractional pixel coords fx, fy
    [B*img_tile, *out] (the caller has resolved align_corners into them).
    ``img_grad=False`` declares the image gradient-free; ``img_tile > 1``
    lets grid element bi sample image bi // img_tile and requires
    ``img_grad=False``."""
    if img_grad and img_tile != 1:
        raise ValueError("img_tile > 1 requires img_grad=False (grid elements sharing an "
                         "image would race on d_img)")
    if not img_grad:
        img = img.detach()
    if img.device.type == "cpu":
        return grid_sample_reference(img.float(), fx.float(), fy.float(), zeros_mode,
                                     img_tile)
    if img.device.type != "cuda":
        raise ValueError(f"grid_sample_mm: unsupported device {img.device}")
    return _GridSample.apply(img.float().contiguous(), fx.float().contiguous(),
                             fy.float().contiguous(), bool(zeros_mode), bool(img_grad),
                             int(img_tile))


def splat_cuda(x, y, height: int, width: int):
    """Launch the splat kernel; occupancy [B, height, width] f32, summed
    with atomics (its last bits vary from run to run)."""
    _require_cuda_f32("splat", x=x, y=y)
    if x.shape != y.shape or x.ndim != 2:
        raise ValueError(f"splat: x {tuple(x.shape)} and y {tuple(y.shape)} must both be [B, P]")
    b, p = x.shape
    occ = torch.zeros((b, height, width), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.endodav_splat(x.data_ptr(), y.data_ptr(), occ.data_ptr(), b, p, height, width,
                                _build.stream_of(x))
    _build.check(err, "splat")
    splat_cuda.launches += 1
    return occ


class _Splat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, height, width):
        ctx.save_for_backward(x, y)
        ctx.hw = (height, width)
        return splat_cuda(x, y, height, width)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        with torch.enable_grad():
            xr, yr = x.detach().requires_grad_(), y.detach().requires_grad_()
            dx, dy = torch.autograd.grad(splat_reference(xr, yr, *ctx.hw), (xr, yr), g)
        return dx, dy, None, None


def splat_mm(x, y, height: int, width: int):
    """Forward-splat unit bilinear mass at pixel coords x, y [B, P] ->
    occupancy [B, height, width] f32."""
    if x.device.type == "cpu":
        return splat_reference(x.float(), y.float(), height, width)
    if x.device.type != "cuda":
        raise ValueError(f"splat_mm: unsupported device {x.device}")
    return _Splat.apply(x.float().contiguous(), y.float().contiguous(), height, width)


for _fn in (grid_sample_fwd_cuda, grid_sample_bwd_coord_cuda, grid_sample_bwd_fused_cuda,
            splat_cuda):
    _fn.launches = 0
