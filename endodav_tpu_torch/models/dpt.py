"""Temporal DPT decoder over four ViT taps -> multi-scale disparity.

Port of `endodav_tpu/models/dpt.py` for the EndoDAV serving path (no
BatchNorm, no cls readout): per-tap 1x1 projections and resize stages,
3x3 "scratch" convs, four FeatureFusionBlocks in the reference out_conv
order, TemporalModules on layer_3/layer_4 and path_4/path_3, and either
the multi-scale HeadDepth sigmoid heads or the single output-conv head.
``prefix`` is strictly per frame; ``suffix`` holds everything that mixes
frames.  Maps are channels-last [B*T, H, W, C]; parameter names follow
the reference state-dict keys under ``head.``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.models.motion import TemporalModule
from endodav_tpu_torch.models.vit import conv_nhwc
from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["DPTDecoder", "HeadDepth"]


def _up(x, size):
    return resize2d(x, size, "bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus the skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y = conv_nhwc(self.conv1, F.relu(x))
        y = conv_nhwc(self.conv2, F.relu(y))
        return y + x


class FeatureFusionBlock(nn.Module):
    """Fuse an optional skip, refine, upsample (align_corners=True), then
    the 1x1 out_conv at the upsampled resolution (reference order).  The
    pyramid top (refinenet4) never receives a skip and has no
    resConfUnit1."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size: tuple[int, int] | None = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[1] * 2, x.shape[2] * 2)
        return conv_nhwc(self.out_conv, _up(x, tuple(size)))


class HeadDepth(nn.Module):
    """conv3x3 -> 2x bilinear (AC=True) -> conv3x3 -> relu -> conv1x1;
    raw logits (torch Sequential indices 0/2/4)."""

    def __init__(self, features: int):
        super().__init__()
        self.head = nn.ModuleList([
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1)])

    def forward(self, x):
        x = conv_nhwc(self.head[0], x)
        x = _up(x, (x.shape[1] * 2, x.shape[2] * 2))
        x = F.relu(conv_nhwc(self.head[2], x))
        return conv_nhwc(self.head[4], x)


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int], conv_head: bool):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(out_channels[i], features, 3, padding=1, bias=False))
        self.refinenet1 = FeatureFusionBlock(features)
        self.refinenet2 = FeatureFusionBlock(features)
        self.refinenet3 = FeatureFusionBlock(features)
        self.refinenet4 = FeatureFusionBlock(features, has_skip=False)
        if not conv_head:
            self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
            self.output_conv2 = nn.ModuleList([
                nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                nn.Conv2d(32, 1, 1), nn.ReLU()])

    def output_head(self, x, out_hw):
        """The single output-conv head: 3x3 -> upsample -> 3x3 -> relu -> 1x1 -> relu."""
        x = _up(conv_nhwc(self.output_conv1, x), out_hw)
        x = F.relu(conv_nhwc(self.output_conv2[0], x))
        return F.relu(conv_nhwc(self.output_conv2[2], x))


class DPTDecoder(nn.Module):
    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 num_frames: int = 32, conv_head: bool = True, inv_sigmoid: bool = False,
                 out_sigmoid: bool = False, temporal_lora_variant: str = "none",
                 lora_rank: int = 4, lora_alpha: float | None = None):
        super().__init__()
        self.conv_head = conv_head
        self.inv_sigmoid = inv_sigmoid
        self.out_sigmoid = out_sigmoid
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, oc, 1) for oc in out_channels)
        # torch Conv2d(k=3, s=2, padding=1) pads (1, 1) on both sides
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, stride=4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, stride=2, padding=1)])
        motion = lambda ch: TemporalModule(  # noqa: E731
            ch, temporal_max_len=num_frames, lora_variant=temporal_lora_variant,
            lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.motion_modules = nn.ModuleList([
            motion(out_channels[2]), motion(out_channels[3]), motion(features),
            motion(features)])
        self.scratch = Scratch(features, out_channels, conv_head)
        if conv_head:
            for i in (1, 2, 3, 4):
                setattr(self, f"conv_depth_{i}", HeadDepth(features))

    def prefix(self, taps, patch_hw: tuple[int, int]):
        """Per-frame front half: taps -> (layer_1_rn, layer_2_rn, layer_3, layer_4)."""
        ph, pw = patch_hw
        maps = []
        for i, (tokens, _cls) in enumerate(taps):
            x = tokens.reshape(tokens.shape[0], ph, pw, tokens.shape[-1])
            x = conv_nhwc(self.projects[i], x)
            if i != 2:
                x = conv_nhwc(self.resize_layers[i], x)
            maps.append(x)
        layer_1, layer_2, layer_3, layer_4 = maps
        s = self.scratch
        return conv_nhwc(s.layer1_rn, layer_1), conv_nhwc(s.layer2_rn, layer_2), layer_3, layer_4

    def suffix(self, maps, frames: int, train: bool = False):
        """Window half: temporal modules + fusion pyramid + heads; ``train``
        picks the motion modules' route (models/motion.py)."""
        layer_1_rn, layer_2_rn, layer_3, layer_4 = maps
        s = self.scratch
        layer_3 = self.motion_modules[0](layer_3, frames, train)
        layer_4 = self.motion_modules[1](layer_4, frames, train)
        layer_3_rn = conv_nhwc(s.layer3_rn, layer_3)
        layer_4_rn = conv_nhwc(s.layer4_rn, layer_4)

        path_4 = s.refinenet4(layer_4_rn, None, layer_3_rn.shape[1:3])
        path_4 = self.motion_modules[2](path_4, frames, train)
        path_3 = s.refinenet3(path_4, layer_3_rn, layer_2_rn.shape[1:3])
        path_3 = self.motion_modules[3](path_3, frames, train)
        path_2 = s.refinenet2(path_3, layer_2_rn, layer_1_rn.shape[1:3])
        path_1 = s.refinenet1(path_2, layer_1_rn, None)

        out = {}
        if self.conv_head:
            sign = -1.0 if self.inv_sigmoid else 1.0
            for scale, (head, path) in enumerate(
                    zip((self.conv_depth_1, self.conv_depth_2, self.conv_depth_3,
                         self.conv_depth_4), (path_1, path_2, path_3, path_4))):
                out[("disp", scale)] = torch.sigmoid(sign * head(path))
            return out
        # upsample to 14x the patch grid (4x of it is layer_1_rn's extent)
        out_hw = (layer_1_rn.shape[1] * 14 // 4, layer_1_rn.shape[2] * 14 // 4)
        out[("disp", 0)] = s.output_head(path_1, out_hw)
        for scale in range(1, 4):
            prev = out[("disp", scale - 1)]
            out[("disp", scale)] = _up(prev, (prev.shape[1] // 2, prev.shape[2] // 2))
        if self.out_sigmoid:
            out = {k: torch.sigmoid(v) for k, v in out.items()}
        return out

    def forward(self, taps, patch_hw: tuple[int, int], frames: int = 1, train: bool = False):
        return self.suffix(self.prefix(taps, patch_hw), frames, train)
