"""Fused transformer MLP of the ViT blocks: the CUDA kernel, its plain
version and the wrapper.

Port of `endodav_tpu/kernels/fused_mlp.py`.  ``fused_mlp(x, w1, b1, w2,
b2)`` returns ``fc2(gelu(x W1 + b1)) + b2`` over x [..., C] with the
weights in the JAX layout [in, out], the biases in f32, the hidden
activations rounded to x's dtype between the products and every sum in
f32.  On a CUDA tensor it launches `csrc/fused_mlp.cu` on the tensor cores
(f32 as 3xTF32, bf16 as it is); on a CPU tensor it runs `mlp_reference`,
the port of the JAX `mlp_reference` (exact gelu).  Serving only, as in
JAX: the kernel has no backward, and `Mlp` routes here only under
``ENDODAV_FUSED_MLP`` on the merged graph without int8.

Weights: contiguous, or the transpose of a contiguous tensor (`Mlp` passes
``lin.weight.t()``, the parameter's own storage, which is the K-major
layout the kernel reads).  The kernel's B planes (`tf32x3.kmajor_planes`:
hi and lo for f32) are made once per weight version and kept in
``fused_mlp.planes``; for f32 they take twice the weights' memory.

GELU: the TPU kernel evaluates erf by Abramowitz-Stegun 7.1.26 (|error| <=
1.5e-7), `mlp_reference` exactly, this kernel with CUDA's ``erff`` (at most
2 ulp).  Either error is far below the f32 tolerance of the comparisons
(1e-4 of the output's scale), so one tolerance covers all three.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.tf32x3 import PlaneCache, check_layout, kmajor_planes

__all__ = ["mlp_reference", "fused_mlp", "mlp_config"]

MID_C2 = 384  # csrc/fused_mlp.cu:Mid, a cluster of 2 CTAs a 128-row tile
WIDE_NC = 256  # csrc/fused_mlp.cu:Wide and Tall, output columns a CTA of a cluster
WIDE_CL, MAX_CL = 4, 8  # Wide's 128-row tiles up to 4 CTAs, Tall's 64 rows up to 8
C_STEP = 64  # C is walked in steps of 64 (bf16, and f32 at wide widths)


def mlp_reference(x, w1, b1, w2, b2):
    """Plain version: f32-accumulated products, exact gelu on the f32 fc1
    output, the hidden rounded to x's dtype, the output cast to it."""
    h = x.float() @ w1.float() + b1.float()
    h = F.gelu(h).to(x.dtype)
    y = h.float() @ w2.float() + b2.float()
    return y.to(x.dtype)


def mlp_config(c: int, hdim: int, c2: int) -> tuple[int, int]:
    """(cluster size, rows a tile) of csrc/fused_mlp.cu for widths C -> H ->
    C2: C2 = 384 on a cluster of 2 CTAs (H a multiple of 128); any other
    C2 up to 2048 that is a multiple of 8 on a cluster of cl = ceil(C2/256)
    CTAs (H a multiple of 32*cl), 128 rows a tile up to cl = 4 and 64 rows
    above (vitg's 1536 -> 6144 -> 1536: a cluster of 6); C a multiple of
    64.  Raises for widths the kernel does not take."""
    if c2 == MID_C2:
        cl, rows, hstep = 2, 128, 128
    else:
        cl = -(-c2 // WIDE_NC)
        rows, hstep = (128 if cl <= WIDE_CL else 64), 32 * cl
        if c2 % 8 or not 1 <= cl <= MAX_CL:
            raise ValueError(f"fused_mlp: output width {c2} must be a multiple of 8 and at "
                             f"most {MAX_CL * WIDE_NC}")
    if c % C_STEP or c == 0 or hdim % hstep or hdim == 0:
        raise ValueError(f"fused_mlp: widths {c} -> {hdim} -> {c2} need C a multiple of "
                         f"{C_STEP} and H a multiple of {hstep}")
    return cl, rows


def fused_mlp(x, w1, b1, w2, b2):
    """x [..., C]; w1 [C, H], w2 [H, C2] in x's dtype; b1 [H], b2 [C2] in f32.
    Returns fc2(gelu(fc1(x))) [..., C2] in x's dtype."""
    if x.device.type == "cpu":
        return mlp_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    return _launch(x, w1, b1, w2, b2)


def _launch(x, w1, b1, w2, b2):
    *lead, c = x.shape
    hdim, c2 = w1.shape[1], w2.shape[1]
    code = _build.dtype_code(x, "fused_mlp")
    expect = {"w1": ((c, hdim), x.dtype), "b1": ((hdim,), torch.float32),
              "w2": ((hdim, c2), x.dtype), "b2": ((c2,), torch.float32)}
    for name, a in {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2}.items():
        if name != "x" and (tuple(a.shape), a.dtype) != expect[name]:
            raise ValueError(f"fused_mlp: {name} is {tuple(a.shape)} {a.dtype}, expected "
                             f"{expect[name][0]} {expect[name][1]}")
        if a.device != x.device:
            raise ValueError(f"fused_mlp: {name} must be on {x.device}")
        if name in ("w1", "w2"):
            check_layout(a, f"fused_mlp: {name}")
        elif not a.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous")
    mlp_config(c, hdim, c2)
    rows = x.numel() // c
    if rows == 0:
        return torch.empty((*lead, c2), dtype=x.dtype, device=x.device)
    lib = _build.library()
    if x.data_ptr() % 16:
        raise ValueError("fused_mlp: x must start 16-byte aligned (the kernel copies 16-byte "
                         "vectors)")
    (w1h, w1l), (w2h, w2l) = (kmajor_planes(fused_mlp.planes, w) for w in (w1, w2))
    if any(p.data_ptr() % 16 for p in (w1h, w1l, w2h, w2l)):
        raise ValueError("fused_mlp: the weights must start 16-byte aligned")
    out = torch.empty((*lead, c2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_mlp(code, x.data_ptr(), w1h.data_ptr(), w1l.data_ptr(),
                                    b1.data_ptr(), w2h.data_ptr(), w2l.data_ptr(), b2.data_ptr(),
                                    out.data_ptr(), rows, c, hdim, c2, _build.stream_of(x))
    _build.check(err, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
fused_mlp.planes = PlaneCache()
