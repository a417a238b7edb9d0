"""Spatial ViT attention: the CUDA kernel, its plain version and the wrapper.

Port of `endodav_tpu/kernels/flash_attention.py` (the Pallas
`_attn_kernel`).  `qkv_attention` takes the packed qkv projection
[B, N, 3C] and returns the attention output [B, N, C] with the heads side
by side.  On a CUDA tensor it launches `csrc/flash_attention.cu`, which
reads q, k and v as strided views of the packed tensor; on a CPU tensor
it runs `attention_reference`, the port of the JAX `_xla_attention`.
The serving path runs under `torch.inference_mode()`; the backward pass
comes with the training slice.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.kernels import _build

__all__ = ["attention_reference", "qkv_attention"]

HEAD_DIM = 64  # the one head width the kernel is built for (vits, vitl)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain attention over [B, N, H, Dh]; returns [B, N, H, Dh]
    (`endodav_tpu/ops/attention.py:_xla_attention`)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def qkv_attention(qkv: torch.Tensor, heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head self-attention from a packed projection [B, N, 3C] -> [B, N, C]."""
    b, n, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % heads:
        raise ValueError(f"qkv width {c3} is not 3 * heads * head_dim (heads={heads})")
    c = c3 // 3
    dh = c // heads
    if scale is None:
        scale = dh ** -0.5
    if qkv.device.type == "cpu":
        q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, heads, dh) for i in range(3))
        return attention_reference(q, k, v, scale).reshape(b, n, c)
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv_attention: unsupported device {qkv.device}")
    code = _build.dtype_code(qkv, "qkv_attention")
    if dh != HEAD_DIM:
        raise ValueError(f"qkv_attention: head width {dh} not supported by the kernel "
                         f"(built for {HEAD_DIM})")
    if qkv.stride(2) != 1 or qkv.stride(1) < c3 or qkv.stride(0) < n * qkv.stride(1):
        raise ValueError(f"qkv_attention: qkv must have unit column stride and "
                         f"non-overlapping rows, got strides {qkv.stride()}")
    lib = _build.library()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    # q, k and v are the column blocks 0, C and 2C of each packed row
    base, step = qkv.data_ptr(), c * qkv.element_size()
    with torch.cuda.device(qkv.device):
        err = lib.endodav_flash_attention(
            code, base, base + step, base + 2 * step, out.data_ptr(),
            b, n, heads, dh, qkv.stride(1), qkv.stride(0), float(scale), _build.stream_of(qkv))
    _build.check(err, "flash_attention")
    qkv_attention.launches += 1
    return out


qkv_attention.launches = 0
