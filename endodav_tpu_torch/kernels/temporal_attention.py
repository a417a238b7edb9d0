"""Attention along the time axis: the CUDA kernel, its plain version and
the wrapper with its gradient.

Port of `endodav_tpu/kernels/temporal_attention.py`.
``temporal_attention(q, k, v, scale)`` attends over q, k, v [B*, T, H, Dh]
(T <= 64) in f32 or bf16: f32 scores and softmax, p rounded to v's dtype
before PV (:47-52), the output in q's dtype.  On a CUDA tensor the forward
launches `csrc/temporal_attention.cu` (one warp a row and head,
`csrc/warp_attention.cuh`); on a CPU tensor it runs
`temporal_attention_reference`.  Without a gradient to track the forward
runs alone, outside autograd.  On both, the gradient is
`temporal_attention_backward`, the port of JAX's ``_bwd`` (:89-99): plain
einsums with the softmax recomputed in f32, as JAX's ``custom_vjp``.  Both
are the functions of the flash-attention kernel's plain version and
backward (JAX's two ``_bwd`` are the same einsums), shared from
`kernels/flash_attention.py`.

The motion modules' unfused sub-block calls it (`models/motion.py`): the
training step and every RoPE module.
"""

from __future__ import annotations

import functools

import torch

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.flash_attention import attention_backward as \
    temporal_attention_backward
from endodav_tpu_torch.kernels.flash_attention import attention_reference as \
    temporal_attention_reference

__all__ = ["MAX_T", "temporal_attention", "temporal_attention_reference",
           "temporal_attention_backward", "warps_per_block"]

MAX_T = 64
MAX_WARPS = 4            # warps a block: one (row, head) each
SMEM_LIMIT = 232448      # bytes of shared memory one Hopper block may use


def _odd_words(n: int) -> int:
    """csrc/warp_attention.cuh:odd_words: n rounded up to an odd number of
    4-float words."""
    return ((-(-n // 4)) | 1) * 4


def warp_bytes(t: int, dh: int) -> int:
    """Mirror of csrc/temporal_attention.cu:warp_floats, in bytes: one
    warp's q, k, v [TM, ld] and p [QB, pld] in f32, TM the keys padded to
    16, 32 or 64 and the rows to an odd number of 16-byte words."""
    tm = 16 if t <= 16 else 32 if t <= 32 else 64
    ld = _odd_words(dh)
    return 4 * (3 * tm * ld + (32 if tm >= 32 else 16) * _odd_words(tm))


@functools.lru_cache(maxsize=256)
def warps_per_block(t: int, dh: int) -> int:
    """Warps a block: the most of 4, 2, 1 whose shared memory fits a
    Hopper block (several blocks an SM where they fit)."""
    return next((w for w in (MAX_WARPS, 2, 1) if w * warp_bytes(t, dh) <= SMEM_LIMIT), 0)


def _launch(q, k, v, scale):
    rows, t, heads, dh = q.shape
    code = _build.dtype_code(q, "temporal_attention")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"temporal_attention: {name} is {tuple(a.shape)} {a.dtype} on "
                             f"{a.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"temporal_attention: T={t}; the kernel takes 1..{MAX_T}")
    wpb = warps_per_block(t, dh)
    if not wpb:
        raise ValueError(f"temporal_attention: T={t} Dh={dh} needs {warp_bytes(t, dh)} bytes of "
                         f"shared memory a warp, over the {SMEM_LIMIT} a Hopper block has")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.endodav_temporal_attention(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), rows, t, heads, dh, wpb,
                                             float(scale), _build.stream_of(q))
    _build.check(err, "temporal_attention")
    temporal_attention.launches += 1
    return out


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return temporal_attention_reference(q, k, v, scale)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*temporal_attention_backward(q, k, v, g, ctx.scale), None)


def temporal_attention(q, k, v, scale: float | None = None):
    """Attention over q, k, v [B*, T, H, Dh] along T -> [B*, T, H, Dh]."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal_attention: unsupported device {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _TemporalAttention.apply(q, k, v, float(scale))
    # no gradient wanted: the forward alone, without autograd's bookkeeping
    if q.device.type == "cpu":
        return temporal_attention_reference(q, k, v, float(scale))
    return _launch(q, k, v, float(scale))


temporal_attention.launches = 0
