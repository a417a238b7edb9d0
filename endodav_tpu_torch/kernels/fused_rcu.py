"""Fused DPT ResidualConvUnit: the CUDA kernel, its plain version and the
wrapper with its gradient.

Port of `endodav_tpu/kernels/fused_rcu.py`.  ``fused_rcu(x, conv1, conv2)``
returns ``x + conv2(relu(conv1(relu(x))))`` over channels-last x
[B, H, W, C] (f32 or bf16, C <= 128) with SAME padding, for the two
``nn.Conv2d`` modules of a `ResidualConvUnit`.  On a CUDA tensor it
launches `csrc/fused_rcu.cu` (the torch [C_out, C_in, 3, 3] weights
rearranged once a call into the kernel's [9, C_in, C_out] taps, in x's
dtype); on a CPU tensor it runs `rcu_reference`.  The gradient is a plain
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

__all__ = ["MAX_CHANNELS", "rcu_reference", "fused_rcu", "kernel_taps"]

MAX_CHANNELS = 128  # the TPU kernel's scope; 420 * C f32 of shared memory a block (215 KB)


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


def kernel_taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch [C_out, C_in, 3, 3] -> the kernel's [9, C_in, C_out] taps (rows
    ky, kx, ci as the TPU kernel's [9C, C] panels) in ``dtype``."""
    return w.detach().permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).to(dtype) \
        .contiguous()


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
    t1, t2 = kernel_taps(w1, x.dtype), kernel_taps(w2, x.dtype)
    f1, f2 = b1.detach().float().contiguous(), b2.detach().float().contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_rcu(code, x.data_ptr(), t1.data_ptr(), f1.data_ptr(),
                                    t2.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c,
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
