"""Fused DPT ResidualConvUnit: the CUDA kernel, its plain version and the
wrapper with its gradient.

Port of `endodav_tpu/kernels/fused_rcu.py`.  ``fused_rcu(x, conv1, conv2)``
returns ``x + conv2(relu(conv1(relu(x))))`` over channels-last x
[B, H, W, C] (f32 or bf16, C <= 128) with SAME padding, for the two
``nn.Conv2d`` modules of a `ResidualConvUnit`.  On a CUDA tensor it
launches `csrc/fused_rcu.cu`, an implicit GEMM on the tensor cores (f32
as 3xTF32, bf16 as it is); on a CPU tensor it runs `rcu_reference`.  The
kernel reads each torch [C_out, C_in, 3, 3] weight as K-major taps
[9, CP, CP] (`kernel_taps`, zero-padded to the kernel's width CP), in
x's dtype and for f32 as TF32 hi and lo planes; they are made once per
weight version and kept in ``fused_rcu.planes`` (`tf32x3.PlaneCache`).
`taps_emulation` is a plain emulation of the kernel's f32 arithmetic for
the tests; nothing on the main path calls it.  The gradient is a plain
recompute through `rcu_reference`, as JAX's ``custom_vjp`` (:190-207).
`models/dpt.py` routes here at serving only, under ``ENDODAV_FUSED_RCU``.

bf16: the kernel rounds the intermediate and conv2's output to bf16 (the
TPU kernel's dtype chain); `rcu_reference`, as JAX's, convolves in x's
dtype.  The two agree to bf16's precision, not bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.tf32x3 import PlaneCache, split_tf32, tf32x3_matmul

__all__ = ["MAX_CHANNELS", "rcu_reference", "fused_rcu", "kernel_taps", "padded_width",
           "taps_emulation"]

MAX_CHANNELS = 128  # the TPU kernel's scope
TILE = (8, 16)  # csrc/fused_rcu.cu: TH x TW output pixels a block


def rcu_reference(x, w1, b1, w2, b2):
    """Plain version (`endodav_tpu/kernels/fused_rcu.py:rcu_reference`,
    :57-73): relu, SAME conv + b1, relu, SAME conv + b2, + x, in x's dtype;
    x [B, H, W, C], weights in the torch layout [C_out, C_in, 3, 3]."""
    dt = x.dtype

    def conv(y, w, b):
        out = F.conv2d(y.permute(0, 3, 1, 2), w.to(dt), padding=1).permute(0, 2, 3, 1)
        return out + b.to(dt)

    y = conv(F.relu(x), w1, b1)
    y = conv(F.relu(y), w2, b2)
    return y + x


def padded_width(c: int) -> int:
    """The kernel's channel width for C (csrc/fused_rcu.cu:rcu_padded_width):
    16, 32, 64 or 128; the channels past C are zeros."""
    return next(p for p in (16, 32, 64, 128) if c <= p)


def kernel_taps(w: torch.Tensor, dtype: torch.dtype, width: int | None = None) -> torch.Tensor:
    """torch [C_out, C_in, 3, 3] -> the kernel's K-major taps [9, C_out,
    C_in] (tap 3*ky + kx) in ``dtype``, zero-padded to [9, width, width]
    when a width is given."""
    taps = w.detach().permute(2, 3, 0, 1).reshape(9, w.shape[0], w.shape[1]).to(dtype)
    if width is not None:
        taps = F.pad(taps, (0, width - w.shape[1], 0, width - w.shape[0]))
    return taps.contiguous()


def _planes(w: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's B operand of a conv weight for x's dtype: padded taps,
    (hi, lo) TF32 planes for f32, the bf16 taps twice for bf16; made once
    per weight version (one cache entry per weight, one slot per dtype)."""
    made = fused_rcu.planes.get(w, dict)
    if dtype not in made:
        taps = kernel_taps(w, dtype, padded_width(w.shape[0]))
        made[dtype] = split_tf32(taps) if dtype == torch.float32 else (taps, taps)
    return made[dtype]


def taps_emulation(x, w1, b1, w2, b2):
    """Plain emulation of the kernel's tile arithmetic over channels-last x
    [B, H, W, C] (f32 or bf16), torch-layout weights: per 8x16 output tile,
    relu(x) over the tile with a halo of 2 (zeros outside the image), conv1
    as 9 shifted [pixels x C] . [C x C] products over the K-major taps on
    the 10x18 intermediate region, b1, relu, rounded to x's dtype and
    zeroed outside the image, then conv2 on the output tile, b2 (rounded
    to x's dtype) plus x.  f32 products as three TF32 passes."""
    dt = x.dtype
    b, h, w, c = x.shape
    th, tw = TILE
    f32 = dt == torch.float32
    t1, t2 = (kernel_taps(wt, dt) for wt in (w1, w2))
    b1f, b2f = b1.detach().float(), b2.detach().float()
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    xr = F.pad(F.relu(x), (0, 0, 2, 2 + wp - w, 2, 2 + hp - h))
    inside = torch.zeros((hp + 2, wp + 2, 1), dtype=torch.bool)
    inside[1:1 + h, 1:1 + w] = True
    out = torch.empty((b, hp, wp, c), dtype=dt)

    product = tf32x3_matmul if f32 else torch.matmul

    def conv(src, taps, rows, cols):
        acc = 0
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc = acc + product(src[:, dy:dy + rows, dx:dx + cols].float(), taps[tap].float().t())
        return acc

    for y0 in range(0, hp, th):
        for x0 in range(0, wp, tw):
            mid = conv(xr[:, y0:y0 + th + 4, x0:x0 + tw + 4], t1, th + 2, tw + 2)
            mid = F.relu(mid + b1f).to(dt)
            mid = torch.where(inside[y0:y0 + th + 2, x0:x0 + tw + 2], mid, 0)
            y = (conv(mid, t2, th, tw) + b2f).to(dt)
            out[:, y0:y0 + th, x0:x0 + tw] = y
    return out[:, :h, :w] + x


def _launch(x, w1, b1, w2, b2):
    b, h, w, c = x.shape
    code = _build.dtype_code(x, "fused_rcu")
    if c > MAX_CHANNELS or c % 4:
        raise ValueError(f"fused_rcu: C={c}; the kernel takes multiples of 4 up to {MAX_CHANNELS}")
    for name, t in (("w1", w1), ("w2", w2)):
        if tuple(t.shape) != (c, c, 3, 3):
            raise ValueError(f"fused_rcu: {name} is {tuple(t.shape)}, expected {(c, c, 3, 3)}")
    for name, t in (("b1", b1), ("b2", b2)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_rcu: {name} is {tuple(t.shape)}, expected {(c,)}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"fused_rcu: {name} is on {t.device}, x on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    if x.data_ptr() % 16:
        raise ValueError("fused_rcu: x must start 16-byte aligned (the kernel reads 16-byte "
                         "vectors)")
    (w1h, w1l), (w2h, w2l) = _planes(w1, x.dtype), _planes(w2, x.dtype)
    f1, f2 = b1.detach().float().contiguous(), b2.detach().float().contiguous()
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_rcu(code, x.data_ptr(), w1h.data_ptr(), w1l.data_ptr(),
                                    f1.data_ptr(), w2h.data_ptr(), w2l.data_ptr(),
                                    f2.data_ptr(), out.data_ptr(), b, h, w, c,
                                    _build.stream_of(x))
    _build.check(err, "fused_rcu")
    fused_rcu.launches += 1
    return out


class _FusedRCU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(need)
                      for a, need in zip(args, ctx.needs_input_grad)]
            out = rcu_reference(*inputs)
            wanted = [a for a in inputs if a.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if a.requires_grad else None for a in inputs)


def fused_rcu(x: torch.Tensor, conv1: torch.nn.Conv2d, conv2: torch.nn.Conv2d) -> torch.Tensor:
    """x [B, H, W, C] -> x + conv2(relu(conv1(relu(x)))) [B, H, W, C]."""
    args = (x, conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    if x.device.type == "cpu":
        return rcu_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rcu: unsupported device {x.device}")
    return _FusedRCU.apply(*args)


fused_rcu.launches = 0
fused_rcu.planes = PlaneCache()
