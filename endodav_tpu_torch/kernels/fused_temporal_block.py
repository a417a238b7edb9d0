"""Fused temporal attention sub-block: the CUDA kernels, their plain
versions and the wrapper.

Port of `endodav_tpu/kernels/fused_temporal_block.py` (the Pallas
`_kernel` for C < 512 and `_grouped_kernel` for C >= 512, which compute
the same function).  `fused_temporal_block(x, ...)` returns
``x + Attn(LN(x) + pe) Wo + bo`` over x [B*, T, C] with LayerNorm eps
1e-5, per-head softmax attention along T and the weights in the JAX
layout [C_in, C_out].  On a CUDA tensor it runs
`csrc/fused_temporal_block.cu` at every width: two tensor-core launches
(the q|k|v projection, then the attention with the out-projection; f32 as
3xTF32), in the tiles `tile_config` picks, counted once a call in
``fused_temporal_block.launches``.  On a CPU tensor it runs the plain
versions: `reference_block` (the port of the JAX `reference_block`) below
512 channels, `grouped_reference_block` (the group partial sums of
`_grouped_kernel`, in its order) from 512.  The kernels sum the heads in
order in one f32 accumulator and add x and bo to it before rounding,
which is `grouped_reference_block`'s order at every C (one group below
512 channels): that is the plain version the card is held against.
Shapes the route does not take raise; nothing falls back.
Weights: contiguous, or the transpose of a contiguous tensor (the motion
modules pass ``lin.weight.t()``).  The kernels read them K-major, as hi
and lo planes for f32 (`tf32x3.kmajor_planes`), made from them once per
weight version and kept in ``fused_temporal_block.planes``.
Where a gradient is wanted the kernels sit in `_FusedTemporalBlock`,
whose backward recomputes the plain version under autograd, as JAX's
`_bwd` (fused_temporal_block.py:262-268) does; serving (no gradient)
launches them directly.  The training step does not run this block (JAX
fuses it only at inference); the gradient keeps the wrapper from ever
handing back a result cut off from autograd.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.tf32x3 import PlaneCache, check_layout, kmajor_planes

__all__ = ["reference_block", "grouped_reference_block", "head_groups", "fused_temporal_block",
           "tile_config", "GROUPED_MIN_C"]

GROUPED_MIN_C = 512  # channels from which the CPU's plain version sums head groups
CMAX = 1024  # widest C the kernels' LayerNorm statistics hold


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


def _plain_version(c: int):
    return grouped_reference_block if c >= GROUPED_MIN_C else reference_block


def tile_config(c: int, heads: int, dtype: torch.dtype) -> tuple[int, int]:
    """(bn, hs) of the kernels (checked again by
    csrc/fused_temporal_block.cu): the column tile, 256, 192 or 64 (the
    widest that divides C, at most 8 of them a cluster), and the heads a K
    step of the out-projection, the fewest whose width is a multiple of a
    64-byte stage (16 f32 or 32 bf16 columns) and at most 128.  Raises
    for widths the route does not take."""
    dh = c // heads if heads > 0 and c % heads == 0 else 0
    bk = 16 if dtype == torch.float32 else 32
    bn = next((b for b in (256, 192, 64) if c % b == 0), 0)
    hs = next((h for h in range(1, heads + 1)
               if heads % h == 0 and (h * dh) % bk == 0 and h * dh <= 128), 0) if dh else 0
    if not (c % 64 == 0 and c <= CMAX and dh % 4 == 0 and 0 < dh <= 128 and c // bn <= 8
            and hs):
        raise ValueError(f"fused_temporal_block: C={c} with {heads} heads: the grouped route "
                         f"takes C a multiple of 64 up to {CMAX} in column tiles of 256, 192 or "
                         f"64 (at most 8 a cluster) and a head width (here {dh or c / heads}) "
                         f"that is a multiple of 4 and at most 128")
    return bn, hs


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
    args = (x, gamma, beta, pe, wq, wk, wv, wo, bo)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _FusedTemporalBlock.apply(heads, *args)
    return _launch(*args, heads)  # serving: no autograd bookkeeping


def _launch(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads):
    """Check the CUDA tensors and run the two launches: the q|k|v
    projection into an f32 scratch [B*T, 3C] (JAX keeps q|k|v in f32),
    then the attention and out-projection; returns a new [B*, T, C]."""
    bstar, t, c = x.shape
    code = _build.dtype_code(x, "fused_temporal_block")
    if not 1 <= t <= 32:
        raise ValueError(f"fused_temporal_block: T={t} outside 1..32")
    bn, hs = tile_config(c, heads, x.dtype)
    expect = {"gamma": ((c,), torch.float32), "beta": ((c,), torch.float32),
              "pe": ((t, c), torch.float32), "wq": ((c, c), x.dtype),
              "wk": ((c, c), x.dtype), "wv": ((c, c), x.dtype), "wo": ((c, c), x.dtype),
              "bo": ((c,), x.dtype)}
    args = dict(gamma=gamma, beta=beta, pe=pe, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo)
    for name, a in {"x": x, **args}.items():
        if name != "x" and (tuple(a.shape), a.dtype) != expect[name]:
            raise ValueError(f"fused_temporal_block: {name} is {tuple(a.shape)} {a.dtype}, "
                             f"expected {expect[name][0]} {expect[name][1]}")
        if a.device != x.device:
            raise ValueError(f"fused_temporal_block: {name} must be on {x.device}")
        if name in ("wq", "wk", "wv", "wo"):
            check_layout(a, f"fused_temporal_block: {name}")
        elif not a.is_contiguous():
            raise ValueError(f"fused_temporal_block: {name} must be contiguous")
    lib = _build.library()
    planes = [kmajor_planes(fused_temporal_block.planes, w) for w in (wq, wk, wv, wo)]
    for a in (x, *(p for pair in planes for p in pair)):
        if a.data_ptr() % 16:
            raise ValueError("fused_temporal_block: x and the weights must start 16-byte "
                             "aligned (TMA reads them)")
    out = torch.empty_like(x)
    qkv = torch.empty((bstar * t, 3 * c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.endodav_fused_temporal_block(
            code, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pe.data_ptr(),
            *(hi.data_ptr() for hi, _ in planes), *(lo.data_ptr() for _, lo in planes),
            bo.data_ptr(), out.data_ptr(), qkv.data_ptr(), bstar, t, c, heads, bn, hs,
            float((c // heads) ** -0.5), _build.stream_of(x))
    _build.check(err, "fused_temporal_block")
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0
fused_temporal_block.planes = PlaneCache()
