"""Bilinear grid-sample and forward-splat: the CUDA kernels, their plain
versions and the wrappers with their gradients.

Port of `endodav_tpu/kernels/warp_matmul.py` (`grid_sample_mm` with its
Pallas forward and its two backward kernels, and `splat_mm`).  The
functions are the 4-corner gather and the scatter-add of
`endodav_tpu/ops/sampling.py`; `csrc/warp.cu` computes them with direct
gathers (the TPU's one-hot matmuls existed only because a TPU has no fast
gather).

* `grid_sample_mm(img, fx, fy, ...)` samples img [B, H, W, C] at
  fractional pixel coordinates fx, fy [B * img_tile, *out] and returns
  [B * img_tile, *out, C] f32.  Its gradient is `_GridSample`: the
  backward kernel gives d_fx, d_fy and, with ``img_grad``, accumulates
  d_img with atomics (the fused kernel); without it the coordinate-only
  kernel runs and the image gets no gradient, as JAX's `_mm_bwd` does.
* `splat_mm(x, y, h, w)` spreads unit bilinear mass from pixel coords
  x, y [B, P] onto an occupancy map [B, h, w] f32.  Its backward
  recomputes the plain version's autograd, as JAX's `_splat_fast_bwd`.

Channel planes (``ENDODAV_WARP_CP=1``, C > 1; JAX's `_use_cp`): the image
moves once a call to [B, C, H, W] f32 planes, as JAX's wrapper does
(:798, :894), and the plane-layout kernels sample it there (JAX's
`_fwd_kernel_cp`, `_bwd_coord_kernel_cp`, `_bwd_fused_kernel_cp`); the
fused backward accumulates d_img into planes, moved back to [B, H, W, C].
The function is the same; on the CPU the plane route runs its own plain
version, `grid_sample_planes_reference`, a gather from the planes.

The fused backward tiles the output grid (`BWD_TILE`) and sums each
tile's d_img contributions in shared memory over the bounding box of its
corners when that box fits `BOX_FLOATS`; other tiles add per pixel into
d_img.  `tile_fit_share` is that box rule and `bwd_tiled_reference` the
whole partition in plain PyTorch, for the tests and `chip_smoke.py`; the
kernel counts its tiles that did not fit, read by
`grid_sample_bwd_fused_cuda.global_blocks()` (and the `_cp` twin's).

On a CUDA tensor each wrapper launches its kernel or raises; the plain
versions (`grid_sample_reference`, `grid_sample_planes_reference`,
`splat_reference`) run only for CPU tensors, where autograd
differentiates them.  Each launching function counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["grid_sample_mm", "splat_mm", "grid_sample_reference", "grid_sample_planes_reference",
           "splat_reference", "grid_sample_fwd_cuda", "grid_sample_bwd_coord_cuda",
           "grid_sample_bwd_fused_cuda", "grid_sample_fwd_cp_cuda", "grid_sample_bwd_coord_cp_cuda",
           "grid_sample_bwd_fused_cp_cuda", "splat_cuda", "use_cp", "tile_fit_share",
           "bwd_tiled_reference"]

MAX_CHANNELS = 4  # the kernels' channel loop is unrolled for C = 1..4
# the fused backward's tile (rows, columns) and d_img box budget in floats
# (csrc/warp.cu: TILE_RS * BWD_PX rows of TILE_W columns, BOX_FLOATS)
BWD_TILE = (32, 32)
BOX_FLOATS = 8192


def _axis(f: torch.Tensor, size: int, zeros_mode: bool):
    """One axis as `csrc/warp.cu:axis_corners` has it: the clipped corner
    indices, the lerp weights times the inside masks in zeros mode, and the
    inside masks (1 in border mode)."""
    f0 = torch.floor(f)
    w1 = f - f0
    w0 = 1.0 - w1
    i0, i1 = f0, f0 + 1.0
    if zeros_mode:
        v0 = ((i0 >= 0) & (i0 <= size - 1)).to(f.dtype)
        v1 = ((i1 >= 0) & (i1 <= size - 1)).to(f.dtype)
        w0, w1 = w0 * v0, w1 * v1
    else:
        v0 = v1 = torch.ones_like(f)
    return (_clip(i0, size), _clip(i1, size)), (w0, w1), (v0, v1)


def _clip(i, size: int):
    """Corner index i clipped into [0, size - 1] as the kernels clip it
    (`fmaxf` sends NaN to 0)."""
    return i.nan_to_num(0.0).clamp(0, size - 1).long()


def grid_sample_reference(img, fx, fy, zeros_mode: bool, img_tile: int = 1):
    """Plain version: the 4-corner gather of `ops/sampling.py:grid_sample`
    (:114-134 of the JAX package) over img [B, H, W, C], fx/fy
    [B*img_tile, *out] -> [B*img_tile, *out, C]."""
    b_img, h, w, c = img.shape
    bg = fx.shape[0]
    out_sp = fx.shape[1:]
    flat = img.reshape(b_img, h * w, c)
    src = (torch.arange(bg, device=img.device) // img_tile)[:, None]
    (x0, x1), (wx0, wx1), _ = _axis(fx.reshape(bg, -1), w, zeros_mode)
    (y0, y1), (wy0, wy1), _ = _axis(fy.reshape(bg, -1), h, zeros_mode)
    out = 0.0
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            out = out + (wy * wx)[..., None] * flat[src, yi * w + xi]
    return out.reshape(bg, *out_sp, c)


def grid_sample_planes_reference(planes, fx, fy, zeros_mode: bool, img_tile: int = 1):
    """Plain version of the channel-plane kernels: the gather of
    `grid_sample_reference` from planes [B, C, H, W] -> [B*img_tile, *out, C]."""
    b_img, c, h, w = planes.shape
    bg = fx.shape[0]
    out_sp = fx.shape[1:]
    flat = planes.reshape(b_img, c, h * w)
    src = (torch.arange(bg, device=planes.device) // img_tile)[:, None, None]
    chan = torch.arange(c, device=planes.device)[None, :, None]
    (x0, x1), (wx0, wx1), _ = _axis(fx.reshape(bg, 1, -1), w, zeros_mode)
    (y0, y1), (wy0, wy1), _ = _axis(fy.reshape(bg, 1, -1), h, zeros_mode)
    out = 0.0
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            out = out + (wy * wx) * flat[src, chan, yi * w + xi]
    return out.transpose(1, 2).reshape(bg, *out_sp, c)


def use_cp(c: int) -> bool:
    """The channel-plane route: C > 1 under ``ENDODAV_WARP_CP`` (JAX's `_use_cp`)."""
    return c > 1 and env_on("ENDODAV_WARP_CP")


def to_planes(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C, H, W] f32 planes (JAX's wrapper, :798 and :894)."""
    return img.float().permute(0, 3, 1, 2).contiguous()


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


def _grid_rows(f):
    """Coordinates [Bg, *out] as the [Bg, ph, pw] output grid the kernels tile."""
    return f.reshape(f.shape[0], -1, f.shape[-1] if f.dim() > 1 else 1)


def _tile_boxes(fx, fy, h: int, w: int, c: int, tile=BWD_TILE, budget: int = BOX_FLOATS):
    """The fused backward's partition: each output pixel's tile [Bg, ph, pw]
    (row-major over grid element, tile row, tile column), and each tile's box
    of clipped corner indices (x0, y0, box width, box height) and whether its
    ``c`` channels fit ``budget`` floats."""
    fx3, fy3 = _grid_rows(fx), _grid_rows(fy)
    bg, ph, pw = fx3.shape
    th, tw = tile
    ny, nx = -(-ph // th), -(-pw // tw)
    dev = fx.device
    tid = ((torch.arange(bg, device=dev)[:, None, None] * ny
            + (torch.arange(ph, device=dev) // th)[None, :, None]) * nx
           + (torch.arange(pw, device=dev) // tw)[None, None, :]).reshape(-1)
    n = bg * ny * nx
    lo, hi = [], []
    for f, size in ((fx3, w), (fy3, h)):
        f0 = torch.floor(f).reshape(-1)
        i0, i1 = _clip(f0, size), _clip(f0 + 1.0, size)
        lo.append(torch.full((n,), size, dtype=torch.long, device=dev)
                  .scatter_reduce(0, tid, i0, "amin"))
        hi.append(torch.full((n,), -1, dtype=torch.long, device=dev)
                  .scatter_reduce(0, tid, i1, "amax"))
    bw, bh = hi[0] - lo[0] + 1, hi[1] - lo[1] + 1
    return tid.reshape(bg, ph, pw), lo[0], lo[1], bw, bh, bw * bh * c <= budget


def tile_fit_share(fx, fy, h: int, w: int, c: int = 1, tile=BWD_TILE,
                   budget: int = BOX_FLOATS) -> float:
    """The share of the fused backward's tiles whose d_img box (the bounding
    box of their clipped corner indices, ``c`` channels) fits the kernel's
    shared-memory budget, for coordinates fx, fy [Bg, *out] on an h x w image."""
    return _tile_boxes(fx, fy, h, w, c, tile, budget)[-1].double().mean().item()


def bwd_tiled_reference(img, fx, fy, g, zeros_mode: bool, planes: bool = False,
                        tile=BWD_TILE, budget: int = BOX_FLOATS):
    """The fused backward's decomposition in plain PyTorch, for the tests and
    `chip_smoke.py`: img [B, H, W, C] (with ``planes``, [B, C, H, W]), fx, fy
    [B, *out], the cotangent g [B, *out, C].  The coordinate gradients per
    pixel; d_img through the kernel's partition: each tile whose box fits
    ``budget`` sums its contributions into a local box that is then added
    into d_img, the other tiles add theirs pixel by pixel.  Returns (d_img in
    img's layout, d_fx, d_fy, the share of tiles that fit)."""
    if planes:
        b, c, h, w = img.shape
        flat = img.reshape(b, c, h * w)
    else:
        b, h, w, c = img.shape
        flat = img.reshape(b, h * w, c)
    fx3, fy3 = _grid_rows(fx).reshape(b, -1), _grid_rows(fy).reshape(b, -1)
    gq = g.reshape(b, -1, c)
    (x0, x1), (wx0, wx1), (vx0, vx1) = _axis(fx3, w, zeros_mode)
    (y0, y1), (wy0, wy1), (vy0, vy1) = _axis(fy3, h, zeros_mode)
    src = torch.arange(b, device=img.device)[:, None]

    def val(yi, xi):  # [B, P, C]
        return (flat[src[:, :, None], torch.arange(c, device=img.device), (yi * w + xi)[..., None]]
                if planes else flat[src, yi * w + xi])

    v00, v01, v10, v11 = val(y0, x0), val(y0, x1), val(y1, x0), val(y1, x1)
    wx0_, wx1_, wy0_, wy1_ = (t[..., None] for t in (wx0, wx1, wy0, wy1))
    dwy0 = (gq * (wx0_ * v00 + wx1_ * v01)).sum(-1)
    dwy1 = (gq * (wx0_ * v10 + wx1_ * v11)).sum(-1)
    dwx0 = (gq * (wy0_ * v00 + wy1_ * v10)).sum(-1)
    dwx1 = (gq * (wy0_ * v01 + wy1_ * v11)).sum(-1)
    dfx = (dwx1 * vx1 - dwx0 * vx0).reshape(fx.shape)
    dfy = (dwy1 * vy1 - dwy0 * vy0).reshape(fy.shape)

    tid, bx0, by0, bw, bh, fits = _tile_boxes(fx, fy, h, w, c, tile, budget)
    tid = tid.reshape(b, -1)
    chan = torch.arange(c, device=img.device)

    def at(v):  # a tile's value at each of its pixels, [B, P, 1]
        return v[tid][..., None]

    def offset(yi, xi, hh, ww):  # [B, P, C] offsets of pixel (yi, xi) in [hh, ww] images
        return (chan * hh + yi) * ww + xi if planes else (yi * ww + xi) * c + chan

    sizes = torch.where(fits, bw * bh * c, 0)
    box_at = torch.cumsum(sizes, 0) - sizes  # each fitting tile's box in `boxes`
    boxes = torch.zeros(int(sizes.sum()), dtype=img.dtype, device=img.device)
    dimg = torch.zeros(b * h * w * c, dtype=img.dtype, device=img.device)
    fit = at(fits).expand(-1, -1, c)
    for yi, xi, wy, wx in ((y0, x0, wy0_, wx0_), (y0, x1, wy0_, wx1_),
                           (y1, x0, wy1_, wx0_), (y1, x1, wy1_, wx1_)):
        a = gq * wy * wx
        yi, xi = yi[..., None], xi[..., None]
        local = at(box_at) + offset(yi - at(by0), xi - at(bx0), at(bh), at(bw))
        boxes.index_add_(0, local[fit], a[fit])
        dimg.index_add_(0, (src[..., None] * (h * w * c) + offset(yi, xi, h, w))[~fit], a[~fit])
    # flush: every box entry back to its pixel of d_img
    t = torch.repeat_interleave(torch.arange(fits.numel(), device=img.device), sizes)
    i = torch.arange(boxes.numel(), device=img.device) - box_at[t]
    if planes:
        cy, lx = i // bw[t], i % bw[t]
        ch, ly = cy // bh[t], cy % bh[t]
        off = (ch * h + by0[t] + ly) * w + bx0[t] + lx
    else:
        ly, rem = i // (bw[t] * c), i % (bw[t] * c)
        off = ((by0[t] + ly) * w + bx0[t]) * c + rem
    nt = fits.numel() // b  # tiles a grid element
    dimg.index_add_(0, (t // nt) * (h * w * c) + off, boxes)
    return dimg.reshape(img.shape), dfx, dfy, fits.double().mean().item()


def _require_cuda_f32(what: str, **tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _check_shapes(img, fx, fy, img_tile, planes=False):
    if planes:
        b_img, c, h, w = img.shape
    else:
        b_img, h, w, c = img.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"grid_sample: C={c} channels; the kernels take 1..{MAX_CHANNELS}")
    if fx.shape != fy.shape or fx.shape[0] != b_img * img_tile:
        raise ValueError(f"grid_sample: coords {tuple(fx.shape)}/{tuple(fy.shape)} do not "
                         f"match {b_img} images x img_tile {img_tile}")
    return b_img, h, w, c


def _launch_fwd(img, fx, fy, zeros_mode, img_tile, planes):
    _require_cuda_f32("grid_sample", img=img, fx=fx, fy=fy)
    _, h, w, c = _check_shapes(img, fx, fy, img_tile, planes)
    bg, (ph, pw) = fx.shape[0], _grid_rows(fx).shape[1:]
    out = torch.empty((*fx.shape, c), dtype=torch.float32, device=img.device)
    lib = _build.library()
    with torch.cuda.device(img.device):
        err = lib.endodav_grid_sample_fwd(img.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                                          out.data_ptr(), bg, ph * pw, pw, h, w, c, img_tile,
                                          int(zeros_mode), int(planes), _build.stream_of(img))
    _build.check(err, "grid_sample_fwd")
    return out


def grid_sample_fwd_cuda(img, fx, fy, zeros_mode: bool, img_tile: int = 1):
    """Launch the forward kernel on img [B, H, W, C]; returns [Bg, *out, C] f32."""
    out = _launch_fwd(img, fx, fy, zeros_mode, img_tile, False)
    grid_sample_fwd_cuda.launches += 1
    return out


def grid_sample_fwd_cp_cuda(planes, fx, fy, zeros_mode: bool, img_tile: int = 1):
    """Launch the plane-layout forward (`_fwd_kernel_cp`) on planes
    [B, C, H, W]; returns [Bg, *out, C] f32."""
    out = _launch_fwd(planes, fx, fy, zeros_mode, img_tile, True)
    grid_sample_fwd_cp_cuda.launches += 1
    return out


def _launch_bwd(img, fx, fy, g, zeros_mode, img_tile, dimg, planes=False, fused=None):
    """Launch a backward kernel; with ``dimg`` the fused one, whose count of
    tiles that took global atomics lands in a counter kept on ``fused``."""
    _require_cuda_f32("grid_sample backward", img=img, fx=fx, fy=fy, g=g)
    _, h, w, c = _check_shapes(img, fx, fy, img_tile, planes)
    bg, (ph, pw) = fx.shape[0], _grid_rows(fx).shape[1:]
    dfx, dfy = torch.empty_like(fx), torch.empty_like(fy)
    counter = None
    if dimg is not None:
        counter = torch.zeros(1, dtype=torch.int32, device=img.device)
        fused.last_counter = counter
        fused.last_tiles = bg * -(-ph // BWD_TILE[0]) * -(-pw // BWD_TILE[1])
    lib = _build.library()
    with torch.cuda.device(img.device):
        err = lib.endodav_grid_sample_bwd(
            img.data_ptr(), fx.data_ptr(), fy.data_ptr(), g.data_ptr(), dfx.data_ptr(),
            dfy.data_ptr(), None if dimg is None else dimg.data_ptr(),
            None if counter is None else counter.data_ptr(), bg, ph * pw, pw, h, w, c,
            img_tile, int(zeros_mode), int(planes), _build.stream_of(img))
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
    dfx, dfy = _launch_bwd(img, fx, fy, g, zeros_mode, 1, dimg, fused=grid_sample_bwd_fused_cuda)
    grid_sample_bwd_fused_cuda.launches += 1
    return dimg, dfx, dfy


def grid_sample_bwd_coord_cp_cuda(planes, fx, fy, g, zeros_mode: bool, img_tile: int = 1):
    """Plane-layout coordinate-only backward (`_bwd_coord_kernel_cp`)."""
    out = _launch_bwd(planes, fx, fy, g, zeros_mode, img_tile, None, True)
    grid_sample_bwd_coord_cp_cuda.launches += 1
    return out


def grid_sample_bwd_fused_cp_cuda(planes, fx, fy, g, zeros_mode: bool):
    """Plane-layout fused backward (`_bwd_fused_kernel_cp`): (d_planes
    [B, C, H, W], d_fx, d_fy), d_planes summed with atomics."""
    dplanes = torch.zeros_like(planes)
    dfx, dfy = _launch_bwd(planes, fx, fy, g, zeros_mode, 1, dplanes, True,
                           fused=grid_sample_bwd_fused_cp_cuda)
    grid_sample_bwd_fused_cp_cuda.launches += 1
    return dplanes, dfx, dfy


def _global_blocks(fused):
    def global_blocks() -> int:
        """Tiles of the last launch whose d_img box did not fit shared memory
        and took per-pixel global atomics (of ``.last_tiles``); waits for
        that launch, so only checks call it."""
        return 0 if fused.last_counter is None else int(fused.last_counter.item())
    return global_blocks


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, fx, fy, zeros_mode, img_grad, img_tile):
        ctx.zeros_mode, ctx.img_grad, ctx.img_tile = zeros_mode, img_grad, img_tile
        ctx.cp = use_cp(img.shape[-1])
        if ctx.cp:  # the planes are kept for the backward
            img = to_planes(img)
            out = grid_sample_fwd_cp_cuda(img, fx, fy, zeros_mode, img_tile)
        else:
            out = grid_sample_fwd_cuda(img, fx, fy, zeros_mode, img_tile)
        ctx.save_for_backward(img, fx, fy)
        return out

    @staticmethod
    def backward(ctx, g):
        img, fx, fy = ctx.saved_tensors
        g = g.contiguous()
        dimg = None
        if ctx.img_grad and ctx.cp:
            dplanes, dfx, dfy = grid_sample_bwd_fused_cp_cuda(img, fx, fy, g, ctx.zeros_mode)
            dimg = dplanes.permute(0, 2, 3, 1)
        elif ctx.img_grad:
            dimg, dfx, dfy = grid_sample_bwd_fused_cuda(img, fx, fy, g, ctx.zeros_mode)
        elif ctx.cp:  # the caller declared the image gradient-free
            dfx, dfy = grid_sample_bwd_coord_cp_cuda(img, fx, fy, g, ctx.zeros_mode,
                                                     ctx.img_tile)
        else:
            dfx, dfy = grid_sample_bwd_coord_cuda(img, fx, fy, g, ctx.zeros_mode, ctx.img_tile)
        return dimg, dfx, dfy, None, None, None


def grid_sample_mm(img, fx, fy, zeros_mode: bool = False, img_grad: bool = True,
                   img_tile: int = 1):
    """Bilinear sample img [B, H, W, C] at fractional pixel coords fx, fy
    [B*img_tile, *out] (the caller has resolved align_corners into them).
    ``img_grad=False`` declares the image gradient-free; ``img_tile > 1``
    lets grid element bi sample image bi // img_tile and requires
    ``img_grad=False``.  `use_cp` picks the channel-plane route."""
    if img_grad and img_tile != 1:
        raise ValueError("img_tile > 1 requires img_grad=False (grid elements sharing an "
                         "image would race on d_img)")
    if not img_grad:
        img = img.detach()
    if img.device.type == "cpu":
        if use_cp(img.shape[-1]):
            return grid_sample_planes_reference(to_planes(img), fx.float(), fy.float(),
                                                zeros_mode, img_tile)
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
            grid_sample_fwd_cp_cuda, grid_sample_bwd_coord_cp_cuda, grid_sample_bwd_fused_cp_cuda,
            splat_cuda):
    _fn.launches = 0
for _fn in (grid_sample_bwd_fused_cuda, grid_sample_bwd_fused_cp_cuda):
    _fn.last_counter, _fn.last_tiles, _fn.global_blocks = None, 0, _global_blocks(_fn)
