"""Temporal attention ("motion") modules.

Port of `endodav_tpu/models/motion.py` (APE): GroupNorm(32, eps 1e-6)
-> proj_in -> temporal transformer blocks -> proj_out, with a residual
over the stack.  Maps stay channels-last [B*T, H, W, C]; attention runs
along T on [B*H*W, T, C].  ``ff_norm`` has eps 1e-6.  Parameter names
follow the reference state-dict keys (``temporal_transformer.
transformer_blocks.{d}.attention_blocks.{i}.to_q`` ...).

Each attention sub-block ``x + to_out(attn(LN(x) + pe))`` has two routes
over one parameter set, chosen by the ``train`` argument that the
trainer carries down (`train/losses.py:main_phase`), as JAX does:

* ``train=False`` (serving) mirrors the JAX inference path on the TPU,
  the fused Pallas block (`motion.py:216-218`): here the fused CUDA
  kernel, whose LayerNorm has eps 1e-5 as the TPU kernel's.
* ``train=True`` mirrors the JAX train step, which never fuses
  (`motion.py:199-210`) and runs flax's ``nn.LayerNorm`` with its default
  eps 1e-6 (`motion.py:219-221`) and plain attention along T.

The two epsilons differ because the two JAX paths differ; each route
keeps its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.kernels.flash_attention import attention_reference
from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block
from endodav_tpu_torch.models.lora import LoRADense

__all__ = ["TemporalModule", "sinusoidal_time_encoding"]


def sinusoidal_time_encoding(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] sin/cos APE."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


TRAIN_LN_EPS = 1e-6  # flax nn.LayerNorm default, the JAX train step's norm_{i}


class TemporalAttention(nn.Module):
    """Self-attention along T as one residual sub-block."""

    def __init__(self, dim: int, num_heads: int = 8, temporal_max_len: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_time_encoding(temporal_max_len, dim)),
            persistent=False)

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm, train: bool = False) -> torch.Tensor:
        """x + Attn(norm(x) + pe) Wo + bo over x [B*, T, C]."""
        if train:
            return x + self._unfused(x, norm)
        t = x.shape[1]
        jax_layout = lambda lin: lin.weight.t().contiguous()  # noqa: E731  [C_in, C_out]
        out = self.to_out[0]
        return fused_temporal_block(
            x.contiguous(), norm.weight.float().contiguous(), norm.bias.float().contiguous(),
            self.pe[:t].contiguous(), jax_layout(self.to_q), jax_layout(self.to_k),
            jax_layout(self.to_v), jax_layout(out), out.bias.contiguous(), self.num_heads)

    def _unfused(self, x, norm):
        """to_out(attn(LN_1e-6(x) + pe)): the JAX train step's sub-block."""
        bstar, t, c = x.shape
        y = F.layer_norm(x, (c,), norm.weight, norm.bias, TRAIN_LN_EPS) + self.pe[:t].to(x.dtype)
        heads = self.num_heads
        q, k, v = (lin(y).reshape(bstar, t, heads, c // heads)
                   for lin in (self.to_q, self.to_k, self.to_v))
        out = attention_reference(q, k, v, (c // heads) ** -0.5).reshape(bstar, t, c)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP; the out projection optionally carries a LoRA adapter."""

    def __init__(self, dim: int, mult: int = 4, lora_variant: str = "none",
                 lora_rank: int = 4, lora_alpha: float | None = None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  LoRADense(inner, dim, lora_rank, lora_alpha, lora_variant)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, num_attention_blocks: int = 2,
                 temporal_max_len: int = 32, lora_variant: str = "none",
                 lora_rank: int = 4, lora_alpha: float | None = None):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, num_heads, temporal_max_len)
            for _ in range(num_attention_blocks))
        # eps 1e-5 is the fused kernel's (serving); training uses TRAIN_LN_EPS
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5)
                                   for _ in range(num_attention_blocks))
        self.ff = GEGLUFeedForward(dim, lora_variant=lora_variant, lora_rank=lora_rank,
                                   lora_alpha=lora_alpha)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, train: bool = False):  # [B*, T, C]
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(x, norm, train)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer(nn.Module):
    def __init__(self, c: int, num_heads: int, num_transformer_block: int,
                 num_attention_blocks: int, norm_num_groups: int, temporal_max_len: int,
                 lora_variant: str, lora_rank: int, lora_alpha: float | None):
        super().__init__()
        self.norm = nn.GroupNorm(norm_num_groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(c, num_heads, num_attention_blocks, temporal_max_len,
                                     lora_variant, lora_rank, lora_alpha)
            for _ in range(num_transformer_block))
        self.proj_out = nn.Linear(c, c)


class TemporalModule(nn.Module):
    """GroupNorm -> proj_in -> temporal transformer -> proj_out, plus the
    residual.  ``forward(x [B*T, H, W, C], frames, train)`` returns the same
    shape; ``train`` picks the attention route (see the module note)."""

    def __init__(self, in_channels: int, num_attention_heads: int = 8,
                 num_transformer_block: int = 1, num_attention_blocks: int = 2,
                 norm_num_groups: int = 32, temporal_max_len: int = 32,
                 lora_variant: str = "none", lora_rank: int = 4,
                 lora_alpha: float | None = None):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(
            in_channels, num_attention_heads, num_transformer_block, num_attention_blocks,
            norm_num_groups, temporal_max_len, lora_variant, lora_rank, lora_alpha)

    def forward(self, x: torch.Tensor, frames: int, train: bool = False) -> torch.Tensor:
        tt = self.temporal_transformer
        bt, h, w, c = x.shape
        b = bt // frames
        y = tt.norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = tt.proj_in(y.reshape(bt, h * w, c))
        # [(B*T), HW, C] -> [(B*HW), T, C]: time becomes the sequence axis
        y = y.reshape(b, frames, h * w, c).transpose(1, 2).reshape(b * h * w, frames, c)
        for blk in tt.transformer_blocks:
            y = blk(y, train)
        y = y.reshape(b, h * w, frames, c).transpose(1, 2).reshape(bt, h * w, c)
        return tt.proj_out(y).reshape(bt, h, w, c) + x
