"""Temporal attention ("motion") modules.

Port of `endodav_tpu/models/motion.py` (APE and RoPE): GroupNorm(32, eps 1e-6)
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
  eps 1e-6 (`motion.py:219-221`) and attention along T, here the
  temporal-attention kernel (`kernels/temporal_attention.py`).

The two epsilons differ because the two JAX paths differ; each route
keeps its own.  The A/B switches of JAX's `_use_fused_block` (:49) and
`TemporalTransformerBlock` (:206-208) pick the route the same way:
``ENDODAV_NO_FUSED`` sends serving to the unfused route too, and
``ENDODAV_FUSED_TRAIN`` sends the training route to the fused block
(whose backward is a plain recompute, `kernels/fused_temporal_block.py`).  ``pos_embedding_type="rope"`` adds no pe and rotates the
channel pairs of q and k instead (`motion.py:92-106, 139-158`); JAX fuses
APE only (`_use_fused_block`), so a RoPE module takes the unfused route at
serving too.

``dtype`` is the compute dtype of JAX's ``TemporalModule.dtype``: the
GroupNorm, proj_in/proj_out, the sub-blocks' LayerNorms and projections
and the GEGLU feed-forward cast where flax does (`models/cast.py`).  The
fused route hands the kernel x as it comes, the LayerNorm parameters and
pe in f32 and the projections (with bo) in ``dtype`` (JAX :130-137).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block
from endodav_tpu_torch.kernels.temporal_attention import temporal_attention
from endodav_tpu_torch.models.cast import dense, group_norm, layer_norm
from endodav_tpu_torch.models.lora import LoRADense
from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["TemporalModule", "sinusoidal_time_encoding", "rope_tables", "POS_EMBEDDINGS"]

POS_EMBEDDINGS = ("ape", "rope")


def sinusoidal_time_encoding(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] sin/cos APE."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


def rope_tables(dim: int, max_len: int, theta: float = 10000.0):
    """(cos, sin) tables [max_len, dim/2] (`motion.py:rope_tables`)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    ang = np.outer(np.arange(max_len, dtype=np.float64), freqs)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the channel pairs (2i, 2i+1) of x [B*, T, C] by the tables
    [T, C/2] (`motion.py:_apply_rope`)."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    a, b = xr[..., 0], xr[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(x.shape)


TRAIN_LN_EPS = 1e-6  # flax nn.LayerNorm default, the JAX unfused sub-block's norm_{i}


class TemporalAttention(nn.Module):
    """Self-attention along T as one residual sub-block."""

    def __init__(self, dim: int, num_heads: int = 8, temporal_max_len: int = 32,
                 pos_embedding_type: str = "ape", dtype: torch.dtype = torch.float32):
        super().__init__()
        if pos_embedding_type not in POS_EMBEDDINGS:
            raise ValueError(f"pos_embedding_type {pos_embedding_type!r}; one of {POS_EMBEDDINGS}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.pos_embedding_type = pos_embedding_type
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_time_encoding(temporal_max_len, dim)),
            persistent=False)
        if pos_embedding_type == "rope":
            cos, sin = rope_tables(dim, temporal_max_len)
            self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm, train: bool = False) -> torch.Tensor:
        """x + Attn(norm(x) + pe) Wo + bo over x [B*, T, C] (RoPE: no pe, q
        and k rotated)."""
        fused = ((not train or env_on("ENDODAV_FUSED_TRAIN"))
                 and self.pos_embedding_type == "ape" and not env_on("ENDODAV_NO_FUSED"))
        if not fused:
            return x + self._unfused(x, norm)
        t, dt = x.shape[1], self.dtype
        # [C_in, C_out]: a view of the parameter at f32, of its cast at bf16
        jax_layout = lambda lin: lin.weight.to(dt).t()  # noqa: E731
        out = self.to_out[0]
        return fused_temporal_block(
            x.contiguous(), norm.weight.float().contiguous(), norm.bias.float().contiguous(),
            self.pe[:t].contiguous(), jax_layout(self.to_q), jax_layout(self.to_k),
            jax_layout(self.to_v), jax_layout(out), out.bias.to(dt).contiguous(),
            self.num_heads)

    def _unfused(self, x, norm):
        """to_out(attn(LN_1e-6(x) + pe)), or with RoPE to_out(attn) of the
        rotated q, k of LN_1e-6(x): JAX's unfused sub-block."""
        bstar, t, c = x.shape
        dt = self.dtype
        y = layer_norm(norm, x, dt, TRAIN_LN_EPS)
        if self.pos_embedding_type == "ape":
            y = y + self.pe[:t].to(y.dtype)
        q, k, v = (dense(lin, y, dt) for lin in (self.to_q, self.to_k, self.to_v))
        if self.pos_embedding_type == "rope":
            cos, sin = self.rope_cos[:t].to(y.dtype), self.rope_sin[:t].to(y.dtype)
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        heads = self.num_heads
        q, k, v = (a.reshape(bstar, t, heads, c // heads) for a in (q, k, v))
        out = temporal_attention(q, k, v, (c // heads) ** -0.5).reshape(bstar, t, c)
        return dense(self.to_out[0], out, dt)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        value, gate = dense(self.proj, x, self.dtype).chunk(2, dim=-1)
        return value * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP; the out projection optionally carries a LoRA adapter."""

    def __init__(self, dim: int, mult: int = 4, lora_variant: str = "none",
                 lora_rank: int = 4, lora_alpha: float | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner, dtype), nn.Identity(),
                                  LoRADense(inner, dim, lora_rank, lora_alpha, lora_variant,
                                            dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, num_attention_blocks: int = 2,
                 temporal_max_len: int = 32, lora_variant: str = "none",
                 lora_rank: int = 4, lora_alpha: float | None = None,
                 pos_embedding_type: str = "ape", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, num_heads, temporal_max_len, pos_embedding_type, dtype)
            for _ in range(num_attention_blocks))
        # eps 1e-5 is the fused kernel's (APE serving); the unfused route
        # uses TRAIN_LN_EPS
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5)
                                   for _ in range(num_attention_blocks))
        self.ff = GEGLUFeedForward(dim, lora_variant=lora_variant, lora_rank=lora_rank,
                                   lora_alpha=lora_alpha, dtype=dtype)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, train: bool = False):  # [B*, T, C]
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(x, norm, train)
        return x + self.ff(layer_norm(self.ff_norm, x, self.dtype))


class TemporalTransformer(nn.Module):
    def __init__(self, c: int, num_heads: int, num_transformer_block: int,
                 num_attention_blocks: int, norm_num_groups: int, temporal_max_len: int,
                 lora_variant: str, lora_rank: int, lora_alpha: float | None,
                 pos_embedding_type: str = "ape", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = nn.GroupNorm(norm_num_groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(c, num_heads, num_attention_blocks, temporal_max_len,
                                     lora_variant, lora_rank, lora_alpha, pos_embedding_type,
                                     dtype)
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
                 lora_alpha: float | None = None, pos_embedding_type: str = "ape",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.temporal_transformer = TemporalTransformer(
            in_channels, num_attention_heads, num_transformer_block, num_attention_blocks,
            norm_num_groups, temporal_max_len, lora_variant, lora_rank, lora_alpha,
            pos_embedding_type, dtype)

    def forward(self, x: torch.Tensor, frames: int, train: bool = False) -> torch.Tensor:
        tt = self.temporal_transformer
        bt, h, w, c = x.shape
        b, dt = bt // frames, self.dtype
        y = group_norm(tt.norm, x, dt)
        y = dense(tt.proj_in, y.reshape(bt, h * w, c), dt)
        # [(B*T), HW, C] -> [(B*HW), T, C]: time becomes the sequence axis
        y = y.reshape(b, frames, h * w, c).transpose(1, 2).reshape(b * h * w, frames, c)
        for blk in tt.transformer_blocks:
            y = blk(y, train)
        y = y.reshape(b, h * w, frames, c).transpose(1, 2).reshape(bt, h * w, c)
        return dense(tt.proj_out, y, dt).reshape(bt, h, w, c) + x
