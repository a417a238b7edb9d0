"""Attention along the time axis: the CUDA kernel, its plain version and
the wrapper with its gradient.

Port of `endodav_tpu/kernels/temporal_attention.py`.
``temporal_attention(q, k, v, scale)`` attends over q, k, v [B*, T, H, Dh]
(T <= 64) in f32 or bf16: f32 scores and softmax, p rounded to v's dtype
before PV (:47-52), the output in q's dtype.  On a CUDA tensor the forward
launches `csrc/temporal_attention.cu`; on a CPU tensor it runs
`temporal_attention_reference`.  On both, the gradient is
`temporal_attention_backward`, the port of JAX's ``_bwd`` (:89-99): plain
einsums with the softmax recomputed in f32, as JAX's ``custom_vjp``.  Both
are the functions of the flash-attention kernel's plain version and
backward (JAX's two ``_bwd`` are the same einsums), shared from
`kernels/flash_attention.py`.

The motion modules' unfused sub-block calls it (`models/motion.py`): the
training step and every RoPE module.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.flash_attention import attention_backward as \
    temporal_attention_backward
from endodav_tpu_torch.kernels.flash_attention import attention_reference as \
    temporal_attention_reference

__all__ = ["MAX_T", "temporal_attention", "temporal_attention_reference",
           "temporal_attention_backward", "head_group"]

MAX_T = 64
SMEM_TARGET = 48 * 1024  # a block's footprint that leaves room for several blocks an SM
SMEM_LIMIT = 232448      # bytes of shared memory one Hopper block may use


def _smem_bytes(t: int, dh: int, hg: int) -> int:
    """Mirror of csrc/temporal_attention.cu:smem_bytes: q, k, v [T, HG*Dh + 1]
    and the scores [HG, T, T + 1], f32."""
    return (3 * t * (hg * dh + 1) + hg * t * (t + 1)) * 4


def head_group(t: int, heads: int, dh: int) -> tuple[int, int]:
    """(heads a block, threads a block): the most heads dividing ``heads``
    whose footprint stays within SMEM_TARGET (at least one), and one
    thread per (head, query), in whole warps, from 128 (the loads and the
    PV phase have HG*T*Dh items) up to 256."""
    hg = next((g for g in range(heads, 0, -1)
               if heads % g == 0 and _smem_bytes(t, dh, g) <= SMEM_TARGET), 1)
    return hg, min(256, max(128, -(-hg * t // 32) * 32))


def _launch(q, k, v, scale):
    rows, t, heads, dh = q.shape
    code = _build.dtype_code(q, "temporal_attention")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"temporal_attention: {name} is {tuple(a.shape)} {a.dtype} on "
                             f"{a.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"temporal_attention: T={t}; the kernel takes 1..{MAX_T}")
    hg, threads = head_group(t, heads, dh)
    if _smem_bytes(t, dh, hg) > SMEM_LIMIT:
        raise ValueError(f"temporal_attention: T={t} Dh={dh} needs {_smem_bytes(t, dh, hg)} "
                         "bytes of shared memory a block")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.endodav_temporal_attention(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), rows, t, heads, dh, hg, threads,
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
    return _TemporalAttention.apply(q, k, v, float(scale))


temporal_attention.launches = 0
