"""DPT decoder over four ViT taps -> multi-scale disparity.

Port of `endodav_tpu/models/dpt.py`: per-tap 1x1 projections (after the
optional cls readout, ``use_clstoken``: Linear over [tokens, cls] and an
exact GELU) and resize stages, 3x3 "scratch" convs, four
FeatureFusionBlocks in the reference out_conv order, with ``temporal``
TemporalModules on layer_3/layer_4 and path_4/path_3 (EndoDAV's head;
EndoDAC's is built with ``temporal=False`` and has none), and either the
multi-scale HeadDepth sigmoid heads or the single output-conv head.
``prefix`` is strictly per frame; ``suffix`` holds everything that mixes
frames.  Maps are channels-last [B*T, H, W, C]; parameter names follow
the reference state-dict keys under ``head.`` (EndoDAV) or
``depth_head.`` (EndoDAC).

``use_bn`` puts a BatchNorm after each RCU conv (``bn1``, ``bn2``), run
with its running statistics at serving and with the batch's in train mode
(JAX :98-113, ``use_running_average=not train``), which it records as
pending (`models/resnet.py:BatchNorm`, flax's arithmetic), computed in
f32 as flax's ``nn.BatchNorm`` promotes it; such a unit never takes the
fused kernel (JAX :77-78).  ``ENDODAV_LOWRES_OUTCONV`` runs each fusion block's 1x1
out_conv before its bilinear upsample, the A/B order of JAX's
`FeatureFusionBlock` (:145-147); the two orders commute exactly.

At serving (``train=False``) a ResidualConvUnit of at most 128 channels
runs the fused CUDA kernel under ``ENDODAV_FUSED_RCU``, exactly where JAX
routes its Pallas kernel (`endodav_tpu/models/dpt.py:77-82`): every RCU of
the vits head (features 64), none of vitl's (256).  ``pos_embedding_type``
("ape" or "rope") goes to the four motion modules, as in JAX.

``dtype`` is the compute dtype of JAX's ``DPTDecoder.dtype``: every
convolution (the projections, the resize stages, the scratch convs, the
RCUs, the fusion out-convs and the heads) casts its input and weights to
it (`models/cast.py`), and the four motion modules take it.  The plain
RCU adds its skip uncast, as JAX's ``rcu_reference(x.astype(dtype), ...,
skip=x)`` (:99-101); the fused one takes x as it comes (:82-85).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.kernels.fused_rcu import MAX_CHANNELS, fused_rcu
from endodav_tpu_torch.models.cast import conv_nhwc, dense
from endodav_tpu_torch.models.motion import TemporalModule
from endodav_tpu_torch.models.resnet import BatchNorm
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["DPTDecoder", "HeadDepth"]


def _up(x, size):
    return resize2d(x, size, "bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 [-> bn] -> relu -> conv3x3 [-> bn], plus the skip."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, use_bn: bool = False):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.use_bn = use_bn
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        if use_bn:
            self.bn1 = BatchNorm(features)
            self.bn2 = BatchNorm(features)

    def forward(self, x, train: bool = False):
        if self.use_bn:
            y = self.bn1(conv_nhwc(self.conv1, F.relu(x.to(self.dtype)), self.dtype).float(),
                         train)
            y = self.bn2(conv_nhwc(self.conv2, F.relu(y), self.dtype).float(), train)
            return y + x
        if (not train and self.features <= MAX_CHANNELS and x.shape[-1] == self.features
                and env_on("ENDODAV_FUSED_RCU")):
            return fused_rcu(x, self.conv1, self.conv2)
        y = conv_nhwc(self.conv1, F.relu(x.to(self.dtype)), self.dtype)
        y = conv_nhwc(self.conv2, F.relu(y), self.dtype)
        return y + x


class FeatureFusionBlock(nn.Module):
    """Fuse an optional skip, refine, upsample (align_corners=True), then
    the 1x1 out_conv at the upsampled resolution (reference order; before
    it under ``ENDODAV_LOWRES_OUTCONV``).  The pyramid top (refinenet4)
    never receives a skip and has no resConfUnit1."""

    def __init__(self, features: int, has_skip: bool = True, dtype: torch.dtype = torch.float32,
                 use_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features, dtype, use_bn)
        self.resConfUnit2 = ResidualConvUnit(features, dtype, use_bn)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size: tuple[int, int] | None = None, train: bool = False):
        if skip is not None:
            x = x + self.resConfUnit1(skip, train)
        x = self.resConfUnit2(x, train)
        if size is None:
            size = (x.shape[1] * 2, x.shape[2] * 2)
        if env_on("ENDODAV_LOWRES_OUTCONV"):
            return _up(conv_nhwc(self.out_conv, x, self.dtype), tuple(size))
        return conv_nhwc(self.out_conv, _up(x, tuple(size)), self.dtype)


class HeadDepth(nn.Module):
    """conv3x3 -> 2x bilinear (AC=True) -> conv3x3 -> relu -> conv1x1;
    raw logits (torch Sequential indices 0/2/4)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.head = nn.ModuleList([
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1)])

    def forward(self, x):
        dt = self.dtype
        x = conv_nhwc(self.head[0], x, dt)
        x = _up(x, (x.shape[1] * 2, x.shape[2] * 2))
        x = F.relu(conv_nhwc(self.head[2], x, dt))
        return conv_nhwc(self.head[4], x, dt)


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int], conv_head: bool,
                 dtype: torch.dtype = torch.float32, use_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(out_channels[i], features, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}",
                    FeatureFusionBlock(features, has_skip=i != 4, dtype=dtype, use_bn=use_bn))
        if not conv_head:
            self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
            self.output_conv2 = nn.ModuleList([
                nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                nn.Conv2d(32, 1, 1), nn.ReLU()])

    def output_head(self, x, out_hw):
        """The single output-conv head: 3x3 -> upsample -> 3x3 -> relu -> 1x1 -> relu."""
        dt = self.dtype
        x = _up(conv_nhwc(self.output_conv1, x, dt), out_hw)
        x = F.relu(conv_nhwc(self.output_conv2[0], x, dt))
        return F.relu(conv_nhwc(self.output_conv2[2], x, dt))


class DPTDecoder(nn.Module):
    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 num_frames: int = 32, conv_head: bool = True, inv_sigmoid: bool = False,
                 out_sigmoid: bool = False, temporal_lora_variant: str = "none",
                 lora_rank: int = 4, lora_alpha: float | None = None,
                 pos_embedding_type: str = "ape", dtype: torch.dtype = torch.float32,
                 temporal: bool = True, use_bn: bool = False, use_clstoken: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv_head = conv_head
        self.inv_sigmoid = inv_sigmoid
        self.out_sigmoid = out_sigmoid
        self.temporal = temporal
        self.use_clstoken = use_clstoken
        if use_clstoken:
            self.readout_projects = nn.ModuleList(
                nn.Sequential(nn.Linear(2 * in_channels, in_channels), nn.GELU())
                for _ in range(4))
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, oc, 1) for oc in out_channels)
        # torch Conv2d(k=3, s=2, padding=1) pads (1, 1) on both sides
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, stride=4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, stride=2, padding=1)])
        motion = lambda ch: TemporalModule(  # noqa: E731
            ch, temporal_max_len=num_frames, pos_embedding_type=pos_embedding_type,
            lora_variant=temporal_lora_variant, lora_rank=lora_rank, lora_alpha=lora_alpha,
            dtype=dtype)
        if temporal:
            self.motion_modules = nn.ModuleList([
                motion(out_channels[2]), motion(out_channels[3]), motion(features),
                motion(features)])
        self.scratch = Scratch(features, out_channels, conv_head, dtype, use_bn)
        if conv_head:
            for i in (1, 2, 3, 4):
                setattr(self, f"conv_depth_{i}", HeadDepth(features, dtype))

    def prefix(self, taps, patch_hw: tuple[int, int]):
        """Per-frame front half: taps -> (layer_1_rn, layer_2_rn, layer_3, layer_4)."""
        ph, pw = patch_hw
        dt = self.dtype
        maps = []
        for i, (tokens, cls) in enumerate(taps):
            if self.use_clstoken:
                readout = cls[:, None, :].expand_as(tokens)
                tokens = F.gelu(dense(self.readout_projects[i][0],
                                      torch.cat([tokens, readout], dim=-1), dt))
            x = tokens.reshape(tokens.shape[0], ph, pw, tokens.shape[-1])
            x = conv_nhwc(self.projects[i], x, dt)
            if i != 2:
                x = conv_nhwc(self.resize_layers[i], x, dt)
            maps.append(x)
        layer_1, layer_2, layer_3, layer_4 = maps
        s = self.scratch
        return (conv_nhwc(s.layer1_rn, layer_1, dt), conv_nhwc(s.layer2_rn, layer_2, dt),
                layer_3, layer_4)

    def suffix(self, maps, frames: int, train: bool = False):
        """Window half: temporal modules + fusion pyramid + heads; ``train``
        picks the motion modules' route (models/motion.py) and keeps the
        RCUs off the fused kernel."""
        layer_1_rn, layer_2_rn, layer_3, layer_4 = maps
        s = self.scratch
        motion = (self.motion_modules if self.temporal
                  else [lambda y, frames, train: y] * 4)
        layer_3 = motion[0](layer_3, frames, train)
        layer_4 = motion[1](layer_4, frames, train)
        layer_3_rn = conv_nhwc(s.layer3_rn, layer_3, self.dtype)
        layer_4_rn = conv_nhwc(s.layer4_rn, layer_4, self.dtype)

        path_4 = s.refinenet4(layer_4_rn, None, layer_3_rn.shape[1:3], train)
        path_4 = motion[2](path_4, frames, train)
        path_3 = s.refinenet3(path_4, layer_3_rn, layer_2_rn.shape[1:3], train)
        path_3 = motion[3](path_3, frames, train)
        path_2 = s.refinenet2(path_3, layer_2_rn, layer_1_rn.shape[1:3], train)
        path_1 = s.refinenet1(path_2, layer_1_rn, None, train)

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
