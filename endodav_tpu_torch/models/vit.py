"""DINOv2-style Vision Transformer trunk (channels-last images, [B, N, C] tokens).

Port of `endodav_tpu/models/vit.py`: patch embed, cls token, bicubic
pos-embed interpolation with the 0.1 offset, pre-norm blocks with fused
QKV attention (the flash kernel), LayerScale, LoRA-adapted MLPs with
exact GELU (or DINOv2's SwiGLU FFN, ``ffn_layer="swiglu"``, which no
reference configuration uses), the optional ResBottleneck branch on patch
tokens, and intermediate taps with the final LayerNorm applied per tap.
Parameter names follow the reference state-dict keys
(``blocks.{i}.attn.qkv`` ...).

Serving routes, as `models/vit.py:85-116,175-197` of the JAX package:
``quant_int8`` (threaded from `EndoDAV.int8_serving` through the forward,
``ENDODAV_INT8`` overriding it, `ops/quant.py:resolve_int8`) sends the
fused qkv projection, the attention out-projection and the merged MLP's
fc1/fc2 through `int8_dense`; ``ENDODAV_FUSED_MLP`` (default off) sends
the MLP of the merged graph without int8 through the fused-MLP kernel
(an adapted MLP, ssb's included, never takes it: JAX :90-92).

``dtype`` is the compute dtype of JAX's ``DinoViT.dtype`` (f32 by
default; the TPU benchmark serves bf16): parameters stay f32 and every
module casts where flax does (`models/cast.py`).  The cls and position
tokens take the patch tokens' dtype (JAX :401-402); LayerScale and the
ResBottleneck's channel LayerNorm compute in their input's dtype, as JAX's
(:187, :214-215).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.kernels.fused_mlp import fused_mlp
from endodav_tpu_torch.models.cast import conv_nhwc, dense, layer_norm
from endodav_tpu_torch.models.lora import LoRADense
from endodav_tpu_torch.ops.attention import fused_qkv_attention
from endodav_tpu_torch.ops.quant import int8_dense, resolve_int8
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["DinoViT", "SwiGLUFFN", "VIT_CONFIGS"]

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),  # EndoDAC only
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24),  # no option selects it, as in JAX
}


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, lora_variant: str, lora_rank: int,
                 lora_alpha: float | None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = LoRADense(dim, hidden, lora_rank, lora_alpha, lora_variant, dtype)
        self.fc2 = LoRADense(hidden, dim, lora_rank, lora_alpha, lora_variant, dtype)

    def forward(self, x, quant_int8: bool = False):
        if env_on("ENDODAV_FUSED_MLP") and self.fc1.variant == "none" and not quant_int8:
            dt = self.dtype
            # the JAX layout: views of the parameters at f32, of their casts at bf16
            w1, w2 = (lin.weight.to(dt).t() for lin in (self.fc1, self.fc2))
            return fused_mlp(x.to(dt).contiguous(), w1, self.fc1.bias.float(), w2,
                             self.fc2.bias.float())
        return self.fc2(F.gelu(self.fc1(x, quant_int8)), quant_int8)


class SwiGLUFFN(nn.Module):
    """DINOv2's SwiGLU FFN (JAX :119-135): ``w12`` one projection to twice
    the hidden width, silu(x1) * x2, ``w3`` back; the hidden width
    (int(2 * hidden / 3) + 7) // 8 * 8."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        d = (int(hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * d)
        self.w3 = nn.Linear(d, dim)

    def forward(self, x, quant_int8: bool = False):
        x1, x2 = dense(self.w12, x, self.dtype).chunk(2, dim=-1)
        return dense(self.w3, F.silu(x1) * x2, self.dtype)


class SpatialAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, quant_int8: bool = False):
        dt = self.dtype
        if quant_int8:  # the f32 weights, quantized inside (JAX :153-158)
            out = fused_qkv_attention(x, self.qkv.weight, self.qkv.bias, self.num_heads,
                                      quant_int8=True)
            return int8_dense(out, self.proj.weight, self.proj.bias, out_dtype=dt)
        out = fused_qkv_attention(x, self.qkv.weight.to(dt), self.qkv.bias.to(dt),
                                  self.num_heads)
        return dense(self.proj, out, dt)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, H, W, C] maps, eps 1e-6, in
    x's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + 1e-6)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class ResBottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck over patch-token maps [B, ph, pw, C]."""

    def __init__(self, channels: int, bottleneck: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, bottleneck, 1, bias=False)
        self.norm1 = ChannelLayerNorm(bottleneck)
        self.conv2 = nn.Conv2d(bottleneck, bottleneck, 3, padding=1, bias=False)
        self.norm2 = ChannelLayerNorm(bottleneck)
        self.conv3 = nn.Conv2d(bottleneck, channels, 1, bias=False)
        self.norm3 = ChannelLayerNorm(channels)

    def forward(self, x):
        dt = self.dtype
        y = F.gelu(self.norm1(conv_nhwc(self.conv1, x, dt)))
        y = F.gelu(self.norm2(conv_nhwc(self.conv2, y, dt)))
        return self.norm3(conv_nhwc(self.conv3, y, dt))


class ViTBlock(nn.Module):
    """Pre-norm transformer block + optional residual conv branch."""

    def __init__(self, dim: int, num_heads: int, use_residual_block: bool,
                 include_cls_token: bool, lora_variant: str, lora_rank: int,
                 lora_alpha: float | None, dtype: torch.dtype = torch.float32,
                 ffn_layer: str = "mlp"):
        super().__init__()
        self.ofs = 1 if include_cls_token else 0
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SpatialAttention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if ffn_layer == "swiglu":
            self.mlp = SwiGLUFFN(dim, 4 * dim, dtype)
        elif ffn_layer == "mlp":
            self.mlp = Mlp(dim, 4 * dim, lora_variant, lora_rank, lora_alpha, dtype)
        else:
            raise ValueError(f"ffn_layer {ffn_layer!r}: mlp or swiglu")
        self.ls2 = LayerScale(dim)
        if use_residual_block:
            self.residual_ = ResBottleneckBlock(dim, dim // 8, dtype)

    def forward(self, x, patch_hw: tuple[int, int], quant_int8: bool = False):
        dt = self.dtype
        x = x + self.ls1(self.attn(layer_norm(self.norm1, x, dt), quant_int8))
        x = x + self.ls2(self.mlp(layer_norm(self.norm2, x, dt), quant_int8))
        if hasattr(self, "residual_"):
            b, n, c = x.shape
            patches = x[:, self.ofs:].reshape(b, *patch_hw, c)
            patches = patches + self.residual_(patches)
            x = torch.cat([x[:, :self.ofs], patches.reshape(b, n - self.ofs, c)], dim=1)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, images):  # [B, H, W, 3] -> [B, ph*pw, C]
        x = conv_nhwc(self.proj, images, self.dtype)
        return x.reshape(x.shape[0], -1, x.shape[-1])


class DinoViT(nn.Module):
    """DINOv2 ViT trunk; ``forward(images, take_indices)`` returns a list
    of (patch_tokens [B, N, C], cls [B, C]) per tap, post final LayerNorm;
    ``quant_int8`` asks for the int8 serving GEMMs (resolved here, once a
    forward, against ``ENDODAV_INT8``)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, pos_grid: int = 37,
                 residual_block_indexes: Sequence[int] = (), include_cls_token: bool = True,
                 lora_variant: str = "none", lora_rank: int = 4,
                 lora_alpha: float | None = None, dtype: torch.dtype = torch.float32,
                 ffn_layer: str = "mlp"):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.pos_grid = pos_grid
        self.include_cls_token = include_cls_token
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, embed_dim))
        # kept for checkpoint-shape parity with DINOv2 weights (unused)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        residual = set(int(i) for i in residual_block_indexes)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, i in residual, include_cls_token,
                     lora_variant, lora_rank, lora_alpha, dtype, ffn_layer)
            for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolated_pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        """Bicubic pos-embed interpolation with the DINO 0.1 offset."""
        pos_embed = self.pos_embed
        if (ph, pw) == (self.pos_grid, self.pos_grid):
            return pos_embed if self.include_cls_token else pos_embed[:, 1:]
        grid = pos_embed[:, 1:].reshape(1, self.pos_grid, self.pos_grid, self.embed_dim)
        sh = (ph + 0.1) / self.pos_grid
        sw = (pw + 0.1) / self.pos_grid
        grid = resize2d(grid.float(), (ph, pw), "bicubic", align_corners=False,
                        scale_hw=(sh, sw))
        flat = grid.reshape(1, ph * pw, self.embed_dim)
        if self.include_cls_token:
            return torch.cat([pos_embed[:, :1], flat], dim=1)
        return flat

    def forward(self, images: torch.Tensor, take_indices: Sequence[int],
                quant_int8: bool = False):
        b, h, w, _ = images.shape
        ph, pw = h // self.patch_size, w // self.patch_size
        x = self.patch_embed(images)
        if self.include_cls_token:
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim), x], dim=1)
        x = x + self.interpolated_pos_embed(ph, pw).to(x.dtype)
        take = set(int(i) for i in take_indices)
        quant_int8 = resolve_int8(quant_int8)
        results = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, (ph, pw), quant_int8)
            if i in take:
                out = layer_norm(self.norm, x, self.dtype)
                # without a cls token the first patch stands in for it
                results.append((out[:, 1:] if self.include_cls_token else out, out[:, 0]))
        return results
