"""Fused transformer MLP of the ViT blocks: the CUDA kernel, its plain
version and the wrapper.

Port of `endodav_tpu/kernels/fused_mlp.py`.  ``fused_mlp(x, w1, b1, w2,
b2)`` returns ``fc2(gelu(x W1 + b1)) + b2`` over x [..., C] with the
weights in the JAX layout [in, out], the biases in f32, the hidden
activations rounded to x's dtype between the products and every sum in
f32.  On a CUDA tensor it launches `csrc/fused_mlp.cu`; on a CPU tensor it
runs `mlp_reference`, the port of the JAX `mlp_reference` (exact gelu).
Serving only, as in JAX: the kernel has no backward, and `Mlp` routes here
only under ``ENDODAV_FUSED_MLP`` on the merged graph without int8.

GELU: the TPU kernel evaluates erf by Abramowitz-Stegun 7.1.26 (|error| <=
1.5e-7), `mlp_reference` exactly, this kernel with CUDA's ``erff`` (at most
2 ulp).  Either error is far below the f32 tolerance of the comparisons
(1e-4 of the output's scale), so one tolerance covers all three.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from endodav_tpu_torch.kernels import _build

__all__ = ["mlp_reference", "fused_mlp", "mlp_tiles"]

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
SMEM_BUDGET = 200 * 1024
THREAD_TILES = 256  # the first product's 8x4 tiles per hidden tile (one per thread)


def mlp_reference(x, w1, b1, w2, b2):
    """Plain version: f32-accumulated products, exact gelu on the f32 fc1
    output, the hidden rounded to x's dtype, the output cast to it."""
    h = x.float() @ w1.float() + b1.float()
    h = F.gelu(h).to(x.dtype)
    y = h.float() @ w2.float() + b2.float()
    return y.to(x.dtype)


def _smem_bytes(c: int, c2: int, bm: int, ht: int) -> int:
    """Mirror of csrc/fused_mlp.cu's shared-memory size."""
    return (bm * c + bm * ht + bm * c2) * 4


def mlp_tiles(c: int, hdim: int, c2: int) -> tuple[int, int]:
    """(rows a block, hidden columns a tile): the most rows of 32, 16, 8
    whose footprint stays in budget, and the hidden tile that gives every
    thread one 8x4 tile of the first product (halved until it divides H)."""
    for bm in (32, 16, 8):
        ht = min(hdim, THREAD_TILES * 8 * 4 // bm)
        while ht > 4 and hdim % ht:
            ht //= 2
        if _smem_bytes(c, c2, bm, ht) <= SMEM_BUDGET:
            return bm, ht
    return bm, ht


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
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous on {x.device}")
    if c % 4 or c2 % 4 or hdim % 4:
        raise ValueError(f"fused_mlp: widths {c}, {hdim}, {c2} must be multiples of 4")
    bm, ht = mlp_tiles(c, hdim, c2)
    if hdim % ht or ht % 4 or _smem_bytes(c, c2, bm, ht) > SMEM_LIMIT:
        raise ValueError(f"fused_mlp: widths {c} -> {hdim} -> {c2} need "
                         f"{_smem_bytes(c, c2, bm, ht)} bytes of shared memory a block "
                         f"(limit {SMEM_LIMIT}) or have no hidden tile")
    rows = x.numel() // c
    if rows == 0:
        return torch.empty((*lead, c2), dtype=x.dtype, device=x.device)
    lib = _build.library()
    for name, w in (("w1", w1), ("w2", w2)):
        if w.data_ptr() % 16:
            raise ValueError(f"fused_mlp: {name} must start 16-byte aligned "
                             "(the kernel reads weight rows as vectors)")
    out = torch.empty((*lead, c2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_mlp(code, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, c, hdim,
                                    c2, bm, ht, _build.stream_of(x))
    _build.check(err, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
