"""DINOv2-style Vision Transformer trunk (channels-last images, [B, N, C] tokens).

Port of `endodav_tpu/models/vit.py`: patch embed, cls token, bicubic
pos-embed interpolation with the 0.1 offset, pre-norm blocks with fused
QKV attention (the flash kernel), LayerScale, LoRA-adapted MLPs with
exact GELU, the optional ResBottleneck branch on patch tokens, and
intermediate taps with the final LayerNorm applied per tap.  Parameter
names follow the reference state-dict keys (``blocks.{i}.attn.qkv`` ...).

Serving routes, as `models/vit.py:85-116,175-197` of the JAX package:
``quant_int8`` (threaded from `EndoDAV.int8_serving` through the forward,
``ENDODAV_INT8`` overriding it, `ops/quant.py:resolve_int8`) sends the
fused qkv projection, the attention out-projection and the merged MLP's
fc1/fc2 through `int8_dense`; ``ENDODAV_FUSED_MLP`` (default off) sends
the MLP of the merged graph without int8 through the fused-MLP kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.kernels.fused_mlp import fused_mlp
from endodav_tpu_torch.models.lora import LoRADense
from endodav_tpu_torch.ops.attention import fused_qkv_attention
from endodav_tpu_torch.ops.quant import int8_dense, resolve_int8
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["DinoViT", "VIT_CONFIGS", "conv_nhwc"]

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
}


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to a channels-last [B, H, W, C] tensor.
    The permuted views are channels_last memory format, so no copy is made."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, lora_variant: str, lora_rank: int,
                 lora_alpha: float | None):
        super().__init__()
        self.fc1 = LoRADense(dim, hidden, lora_rank, lora_alpha, lora_variant)
        self.fc2 = LoRADense(hidden, dim, lora_rank, lora_alpha, lora_variant)

    def forward(self, x, quant_int8: bool = False):
        if env_on("ENDODAV_FUSED_MLP") and self.fc1.variant == "none" and not quant_int8:
            w1, w2 = (lin.weight.t().contiguous() for lin in (self.fc1, self.fc2))
            return fused_mlp(x.contiguous(), w1, self.fc1.bias.float(), w2,
                             self.fc2.bias.float())
        return self.fc2(F.gelu(self.fc1(x, quant_int8)), quant_int8)


class SpatialAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, quant_int8: bool = False):
        out = fused_qkv_attention(x, self.qkv.weight, self.qkv.bias, self.num_heads,
                                  quant_int8=quant_int8)
        if quant_int8:
            return int8_dense(out, self.proj.weight, self.proj.bias)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, H, W, C] maps, eps 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * self.weight + self.bias


class ResBottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck over patch-token maps [B, ph, pw, C]."""

    def __init__(self, channels: int, bottleneck: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, bottleneck, 1, bias=False)
        self.norm1 = ChannelLayerNorm(bottleneck)
        self.conv2 = nn.Conv2d(bottleneck, bottleneck, 3, padding=1, bias=False)
        self.norm2 = ChannelLayerNorm(bottleneck)
        self.conv3 = nn.Conv2d(bottleneck, channels, 1, bias=False)
        self.norm3 = ChannelLayerNorm(channels)

    def forward(self, x):
        y = F.gelu(self.norm1(conv_nhwc(self.conv1, x)))
        y = F.gelu(self.norm2(conv_nhwc(self.conv2, y)))
        return self.norm3(conv_nhwc(self.conv3, y))


class ViTBlock(nn.Module):
    """Pre-norm transformer block + optional residual conv branch."""

    def __init__(self, dim: int, num_heads: int, use_residual_block: bool,
                 include_cls_token: bool, lora_variant: str, lora_rank: int,
                 lora_alpha: float | None):
        super().__init__()
        self.ofs = 1 if include_cls_token else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SpatialAttention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, lora_variant, lora_rank, lora_alpha)
        self.ls2 = LayerScale(dim)
        if use_residual_block:
            self.residual_ = ResBottleneckBlock(dim, dim // 8)

    def forward(self, x, patch_hw: tuple[int, int], quant_int8: bool = False):
        x = x + self.ls1(self.attn(self.norm1(x), quant_int8))
        x = x + self.ls2(self.mlp(self.norm2(x), quant_int8))
        if hasattr(self, "residual_"):
            b, n, c = x.shape
            patches = x[:, self.ofs:].reshape(b, *patch_hw, c)
            patches = patches + self.residual_(patches)
            x = torch.cat([x[:, :self.ofs], patches.reshape(b, n - self.ofs, c)], dim=1)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, images):  # [B, H, W, 3] -> [B, ph*pw, C]
        x = conv_nhwc(self.proj, images)
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
                 lora_alpha: float | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.pos_grid = pos_grid
        self.include_cls_token = include_cls_token
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, embed_dim))
        # kept for checkpoint-shape parity with DINOv2 weights (unused)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        residual = set(int(i) for i in residual_block_indexes)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, i in residual, include_cls_token,
                     lora_variant, lora_rank, lora_alpha)
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
                out = self.norm(x)
                # without a cls token the first patch stands in for it
                results.append((out[:, 1:] if self.include_cls_token else out, out[:, 0]))
        return results
