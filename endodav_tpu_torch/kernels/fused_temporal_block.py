"""Fused temporal attention sub-block: the CUDA kernel, its plain version
and the wrapper.

Port of `endodav_tpu/kernels/fused_temporal_block.py` (the Pallas
`_kernel`).  `fused_temporal_block(x, ...)` returns
``x + Attn(LN(x) + pe) Wo + bo`` over x [B*, T, C] with LayerNorm eps
1e-5, per-head softmax attention along T and the weights in the JAX
layout [C_in, C_out].  On a CUDA tensor it launches
`csrc/fused_temporal_block.cu`; on a CPU tensor it runs `reference_block`,
the port of the JAX `reference_block`.  Shapes the kernel cannot take
(the shared-memory footprint of vitl's C=1024) raise; nothing falls back.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build

__all__ = ["reference_block", "fused_temporal_block", "rows_per_block"]

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
SMEM_TARGET = 100 * 1024  # more rows per block only while two blocks fit an SM


def reference_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int):
    """Plain version: x + Attn(LN(x)+pe) Wo + bo, per-head softmax(QK^T/sqrt(dh))V."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5) * gamma + beta
    y = (y + pe).to(x.dtype)
    q, k, v = y @ wq, y @ wk, y @ wv
    b, t, c = x.shape
    dh = c // heads
    q = q.reshape(b, t, heads, dh)
    k = k.reshape(b, t, heads, dh)
    v = v.reshape(b, t, heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * dh ** -0.5, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o.reshape(b, t, c).to(x.dtype)
    return x + (o @ wo + bo).to(x.dtype)


def _smem_bytes(t: int, c: int, rpb: int) -> int:
    """Mirror of csrc/fused_temporal_block.cu:smem_bytes."""
    mpad = -(-(rpb * t) // 8) * 8
    return (mpad * c + mpad * (3 * c + 1) + 8 * 32) * 4


def rows_per_block(t: int, c: int) -> int:
    """Rows of [T, C] per block: the most of 4, 2 whose footprint leaves
    room for two blocks per SM (more weight reuse per block), else 1."""
    for rpb in (4, 2):
        if _smem_bytes(t, c, rpb) <= SMEM_TARGET:
            return rpb
    return 1


def fused_temporal_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int = 8):
    """x [B*, T, C]; gamma/beta [C] and pe [T, C] in f32; wq/wk/wv/wo [C, C]
    and bo [C] in x's dtype.  Returns x + Attn(LN(x)+pe) Wo + bo."""
    bstar, t, c = x.shape
    if x.device.type == "cpu":
        return reference_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block: unsupported device {x.device}")
    code = _build.dtype_code(x, "fused_temporal_block")
    if not 1 <= t <= 32:
        raise ValueError(f"fused_temporal_block: T={t} outside 1..32")
    if c % heads or c % 4:
        raise ValueError(f"fused_temporal_block: C={c} must be a multiple of 4 and of "
                         f"heads={heads}")
    expect = {"gamma": ((c,), torch.float32), "beta": ((c,), torch.float32),
              "pe": ((t, c), torch.float32), "wq": ((c, c), x.dtype),
              "wk": ((c, c), x.dtype), "wv": ((c, c), x.dtype), "wo": ((c, c), x.dtype),
              "bo": ((c,), x.dtype)}
    args = dict(gamma=gamma, beta=beta, pe=pe, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    for name, a in {"x": x, **args}.items():
        if name != "x" and (tuple(a.shape), a.dtype) != expect[name]:
            raise ValueError(f"fused_temporal_block: {name} is {tuple(a.shape)} {a.dtype}, "
                             f"expected {expect[name][0]} {expect[name][1]}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"fused_temporal_block: {name} must be contiguous on {x.device}")
    rpb = rows_per_block(t, c)
    smem = _smem_bytes(t, c, rpb)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_temporal_block: C={c}, T={t} needs {smem} bytes of shared memory per "
            f"block, over the {SMEM_LIMIT} a Hopper block has; the head-grouped kernel for "
            "wide channels (the TPU's _grouped_kernel) is not ported yet")
    lib = _build.library()
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if w.data_ptr() % 16:
            raise ValueError(f"fused_temporal_block: {name} must start 16-byte aligned "
                             "(the kernel reads weight rows as vectors)")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_temporal_block(
            code, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pe.data_ptr(),
            wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), bstar, t, c, heads, rpb, float((c // heads) ** -0.5),
            _build.stream_of(x))
    _build.check(err, "fused_temporal_block")
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0
