"""Fused temporal attention sub-block: the CUDA kernel, its plain version
and the wrapper.

Port of `endodav_tpu/kernels/fused_temporal_block.py` (the Pallas
`_kernel` and, for C >= 512, `_grouped_kernel`).  `fused_temporal_block(x, ...)` returns
``x + Attn(LN(x) + pe) Wo + bo`` over x [B*, T, C] with LayerNorm eps
1e-5, per-head softmax attention along T and the weights in the JAX
layout [C_in, C_out].  On a CUDA tensor it launches one of the two
kernels of `csrc/fused_temporal_block.cu`: C < 512 the block kernel, C >=
512 the head-grouped kernel (as `fused_temporal_block.py:252` routes), each
with its own launch count (`fused_temporal_block.launches`,
`launch_grouped.launches`).  On a CPU tensor it runs the plain versions:
`reference_block` (the port of the JAX `reference_block`) below 512
channels, `grouped_reference_block` (the group partial sums of
`_grouped_kernel`, in its order) from 512.  Shapes neither kernel takes
raise; nothing falls back.
On the card the kernels sit in `_FusedTemporalBlock`, whose backward
recomputes `reference_block` under autograd, as JAX's `_bwd`
(fused_temporal_block.py:262-268) does.  The training step does not run
this block (JAX fuses it only at inference); the gradient keeps the
wrapper from ever handing back a result cut off from autograd.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build

__all__ = ["reference_block", "grouped_reference_block", "head_groups", "fused_temporal_block",
           "rows_per_block", "launch_grouped", "GROUPED_MIN_C"]

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
SMEM_TARGET = 100 * 1024  # more rows per block only while two blocks fit an SM
GROUPED_MIN_C = 512  # channels from which the head-grouped kernel runs


def _ln_pe(x, gamma, beta, pe):
    """LN_1e-5(x) * gamma + beta + pe in f32 (two-pass variance), rounded to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * gamma + beta + pe).to(x.dtype)


def reference_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int):
    """Plain version: x + Attn(LN(x)+pe) Wo + bo, per-head softmax(QK^T/sqrt(dh))V."""
    y = _ln_pe(x, gamma, beta, pe)
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


def head_groups(c: int, heads: int) -> int:
    """Head groups of the grouped kernel (`_forward_grouped`:210-212):
    C/256, halved until it divides the heads."""
    groups = max(1, c // 256)
    while heads % groups:
        groups //= 2
    return groups


def grouped_reference_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int):
    """Plain version of the grouped kernel: the block of `reference_block`
    with q|k|v and the attention per head group and the out-projection
    partials of the groups summed in f32 in group order, as JAX's
    `_grouped_kernel` sums them in scratch."""
    y = _ln_pe(x, gamma, beta, pe)
    b, t, c = x.shape
    groups = head_groups(c, heads)
    heads_g, cg = heads // groups, c // groups
    dh = cg // heads_g
    acc = None
    for g in range(groups):
        cols = slice(g * cg, (g + 1) * cg)
        q, k, v = ((y @ w[:, cols]).float().reshape(b, t, heads_g, dh) for w in (wq, wk, wv))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        p = torch.softmax(s * dh ** -0.5, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, cg).to(x.dtype)
        upd = o.float() @ wo[cols].float()
        acc = upd if acc is None else acc + upd
    return (x.float() + acc + bo.float()).to(x.dtype)


def _smem_bytes(t: int, c: int, rpb: int) -> int:
    """Mirror of csrc/fused_temporal_block.cu:smem_bytes."""
    mpad = -(-(rpb * t) // 8) * 8
    return (mpad * c + mpad * (3 * c + 1) + 8 * 32) * 4


def _grouped_smem_bytes(t: int, c: int, groups: int) -> int:
    """Mirror of csrc/fused_temporal_block.cu:grouped_smem_bytes."""
    mpad = -(-t // 8) * 8
    return (mpad * c + mpad * (3 * (c // groups) + 4) + 8 * 32) * 4


def rows_per_block(t: int, c: int) -> int:
    """Rows of [T, C] per block: the most of 4, 2 whose footprint leaves
    room for two blocks per SM (more weight reuse per block), else 1."""
    for rpb in (4, 2):
        if _smem_bytes(t, c, rpb) <= SMEM_TARGET:
            return rpb
    return 1


def _plain_version(c: int):
    return grouped_reference_block if c >= GROUPED_MIN_C else reference_block


class _FusedTemporalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, *args):
        ctx.save_for_backward(*args)
        ctx.heads = heads
        return _launch(*args, heads)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(need)
                      for a, need in zip(args, ctx.needs_input_grad[1:])]
            out = _plain_version(args[0].shape[-1])(*inputs, ctx.heads)
            wanted = [a for a in inputs if a.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (None, *(next(grads) if a.requires_grad else None for a in inputs))


def fused_temporal_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int = 8):
    """x [B*, T, C]; gamma/beta [C] and pe [T, C] in f32; wq/wk/wv/wo [C, C]
    and bo [C] in x's dtype.  Returns x + Attn(LN(x)+pe) Wo + bo."""
    if x.device.type == "cpu":
        return _plain_version(x.shape[-1])(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block: unsupported device {x.device}")
    return _FusedTemporalBlock.apply(heads, x, gamma, beta, pe, wq, wk, wv, wo, bo)


def _launch(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads):
    """Launch the kernel on CUDA tensors; returns a new [B*, T, C]."""
    bstar, t, c = x.shape
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
    if c >= GROUPED_MIN_C:
        return launch_grouped(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads)
    rpb = rows_per_block(t, c)
    smem = _smem_bytes(t, c, rpb)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_temporal_block: C={c}, T={t} needs {smem} bytes of shared "
                         f"memory per block, over the {SMEM_LIMIT} a Hopper block has")
    lib = _build.library()
    _check_aligned(wq, wk, wv, wo)
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


def _check_aligned(*weights):
    for w in weights:
        if w.data_ptr() % 16:
            raise ValueError("fused_temporal_block: the weights must start 16-byte aligned "
                             "(the kernel reads weight rows as vectors)")


def launch_grouped(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads):
    """Launch the head-grouped kernel on CUDA tensors already checked by
    `_launch`; returns a new [B*, T, C]."""
    bstar, t, c = x.shape
    groups = head_groups(c, heads)
    cg = c // groups
    smem = _grouped_smem_bytes(t, c, groups)
    if cg % 4 or smem > SMEM_LIMIT:
        raise ValueError(f"fused_temporal_block: C={c}, T={t} in {groups} head groups needs "
                         f"{smem} bytes of shared memory per block (limit {SMEM_LIMIT})")
    code = _build.dtype_code(x, "fused_temporal_block")
    lib = _build.library()
    _check_aligned(wq, wk, wv, wo)
    out = torch.empty_like(x)
    # f32 sums of the groups' out-projection partials, one row per block
    acc = torch.empty((bstar, t, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_temporal_block_grouped(
            code, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pe.data_ptr(),
            wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), acc.data_ptr(), bstar, t, c, heads, groups,
            float((c // heads) ** -0.5), _build.stream_of(x))
    _build.check(err, "fused_temporal_block (grouped)")
    launch_grouped.launches += 1
    return out


fused_temporal_block.launches = 0
launch_grouped.launches = 0
