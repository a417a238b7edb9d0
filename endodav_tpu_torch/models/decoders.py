"""Pose, intrinsics, position (optical-flow), transform (appearance-flow)
and depth decoders.

Port of `endodav_tpu/models/decoders.py:81-207`, channels-last:
  * PoseDecoder: squeeze 1x1 -> two 3x3 -> 1x1 -> mean-pool -> 0.001 *
    6-DoF for 2 frames, plus the intermediate map the intrinsics head reads
  * IntrinsicsHead: pooled pose feature -> softplus focal (+0.5, times W/H)
    and offsets -> 4x4 K
  * PositionDecoder / TransformDecoder: the monodepth U-Net over the ResNet
    pyramid (reflect-padded 3x3 convs + ELU, 2x bilinear align_corners=False
    upsampling) -> 2-ch flow / 3-ch tanh appearance flow at 4 scales
  * DepthDecoder: the same U-Net -> reflect-padded 3x3 -> sigmoid
    disparity at 4 scales (the legacy AF-SfM model, `models/afsfm.py`;
    the trainer's ``--predictive_mask`` decoder)
  * PoseCNN: the 7-conv PoseNet of ``--pose_model_type posecnn`` (JAX
    :210-229), which the video trainer refuses, as JAX's.
Parameter names are the reference's (``convs.upconv_4_0.conv.conv.weight``,
``convs.position_conv_0.weight``, ``focal_length_conv.weight``,
PoseCNN's ``net.0.weight`` and ``pose_conv.weight`` ...).

``dtype`` is the compute dtype of JAX's decoders' ``dtype``: every
convolution casts its input, kernel and bias to it (`models/cast.py`), so
the outputs come out in it; the U-Net's skip concatenation promotes as
``jnp.concatenate`` does (with the encoder's f32 maps, to f32).  At f32
every cast is the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.models.cast import conv_nhwc
from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["PoseDecoder", "IntrinsicsHead", "PositionDecoder", "TransformDecoder",
           "DepthDecoder", "PoseCNN"]

NUM_CH_DEC = (16, 32, 64, 128, 256)


def _reflect_index(n: int, device) -> torch.Tensor:
    """Source rows of a 1-pixel reflection pad of n rows; a single row
    repeats, as `jnp.pad(mode="reflect")` does (F.pad refuses n=1)."""
    return torch.tensor([min(1, n - 1), *range(n), max(n - 2, 0)], device=device)


def _reflect_conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """3x3 VALID conv in ``dtype`` after a 1-pixel reflection pad, channels-last."""
    _, h, w, _ = x.shape
    y = x.to(dtype)
    y = y.index_select(1, _reflect_index(h, x.device)).index_select(2, _reflect_index(w, x.device))
    return conv_nhwc(conv, y, dtype)


class Conv3x3(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return _reflect_conv(self.conv, x, self.dtype)


class ConvBlock(nn.Module):
    """Reflect-padded 3x3 conv + ELU."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3x3(cin, cout, dtype)

    def forward(self, x):
        return F.elu(self.conv(x))


class PoseDecoder(nn.Module):
    """``forward(features)`` -> (axisangle [B, F, 1, 3], translation
    [B, F, 1, 3], intermediate [B, h, w, 256]) from the last feature map."""

    def __init__(self, in_ch: int = 512, num_frames_to_predict_for: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frames = num_frames_to_predict_for
        self.dtype = dtype
        self.convs = nn.ModuleDict({
            "squeeze": nn.Conv2d(in_ch, 256, 1),
            "pose_0": nn.Conv2d(256, 256, 3, padding=1),
            "pose_1": nn.Conv2d(256, 256, 3, padding=1),
            "pose_2": nn.Conv2d(256, 6 * num_frames_to_predict_for, 1)})

    def forward(self, features):
        c, dt = self.convs, self.dtype
        x = F.relu(conv_nhwc(c["squeeze"], features[-1], dt))
        x = F.relu(conv_nhwc(c["pose_0"], x, dt))
        intermediate = conv_nhwc(c["pose_1"], x, dt)
        x = conv_nhwc(c["pose_2"], F.relu(intermediate), dt).mean(dim=(1, 2))
        out = 0.001 * x.reshape(-1, self.frames, 1, 6)
        return out[..., :3], out[..., 3:], intermediate


class IntrinsicsHead(nn.Module):
    """Learned pinhole intrinsics [B, 4, 4] from the pose decoder's map."""

    def __init__(self, in_ch: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.focal_length_conv = nn.Conv2d(in_ch, 2, 1, bias=False)
        self.offsets_conv = nn.Conv2d(in_ch, 2, 1, bias=False)

    def forward(self, bottleneck, img_width: int, img_height: int):
        b = bottleneck.shape[0]
        pooled = bottleneck.mean(dim=(1, 2), keepdim=True)
        focal = conv_nhwc(self.focal_length_conv, pooled, self.dtype)[:, 0, 0]
        offset = conv_nhwc(self.offsets_conv, pooled, self.dtype)[:, 0, 0]
        wh = torch.tensor([img_width, img_height], dtype=bottleneck.dtype,
                          device=bottleneck.device)
        focal = (F.softplus(focal) + 0.5) * wh
        offset = (offset + 0.5) * wh
        zero, one = torch.zeros_like(focal[:, 0]), torch.ones_like(focal[:, 0])
        rows = [[focal[:, 0], zero, offset[:, 0], zero],
                [zero, focal[:, 1], offset[:, 1], zero],
                [zero, zero, one, zero],
                [zero, zero, zero, one]]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2).reshape(b, 4, 4)


class _UNetDecoder(nn.Module):
    """Monodepth U-Net trunk; subclasses add their per-scale output convs
    to the same ``convs`` dict (the reference's ModuleDict)."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        self.dtype = dtype
        self.convs = nn.ModuleDict()
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            self.convs[f"upconv_{i}_0"] = ConvBlock(cin, NUM_CH_DEC[i], dtype)
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            self.convs[f"upconv_{i}_1"] = ConvBlock(cin, NUM_CH_DEC[i], dtype)

    def levels(self, features):
        x = features[-1]
        out = {}
        for i in range(4, -1, -1):
            x = self.convs[f"upconv_{i}_0"](x)
            x = resize2d(x, (x.shape[1] * 2, x.shape[2] * 2), "bilinear", align_corners=False)
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=-1)
            x = self.convs[f"upconv_{i}_1"](x)
            if i in self.scales:
                out[i] = x
        return out


class PositionDecoder(_UNetDecoder):
    """2-channel optical flow (dy, dx) at each scale: {("position", s)}."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__(num_ch_enc, scales, dtype)
        for s in self.scales:
            self.convs[f"position_conv_{s}"] = nn.Conv2d(NUM_CH_DEC[s], num_output_channels, 3,
                                                         padding=1)

    def forward(self, features):
        lv = self.levels(features)
        return {("position", s): conv_nhwc(self.convs[f"position_conv_{s}"], lv[s], self.dtype)
                for s in self.scales}


class TransformDecoder(_UNetDecoder):
    """3-channel tanh appearance flow at each scale: {("transform", s)}."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__(num_ch_enc, scales, dtype)
        for s in self.scales:
            self.convs[f"transform_conv_{s}"] = Conv3x3(NUM_CH_DEC[s], num_output_channels, dtype)

    def forward(self, features):
        lv = self.levels(features)
        return {("transform", s): torch.tanh(self.convs[f"transform_conv_{s}"](lv[s]))
                for s in self.scales}


class DepthDecoder(_UNetDecoder):
    """1-channel sigmoid disparity at each scale: {("disp", s)}."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(num_ch_enc, scales, dtype)
        for s in self.scales:
            self.convs[f"dispconv_{s}"] = Conv3x3(NUM_CH_DEC[s], num_output_channels, dtype)

    def forward(self, features):
        lv = self.levels(features)
        return {("disp", s): torch.sigmoid(self.convs[f"dispconv_{s}"](lv[s]))
                for s in self.scales}


class PoseCNN(nn.Module):
    """[B, H, W, 3 * frames] -> (axisangle, translation), each
    [B, frames - 1, 1, 3]: seven stride-2 convs + ReLU, padded k // 2 on
    both sides as the reference (pose_cnn.py:16-24), a 1x1 pose conv, the
    spatial mean, times 0.01."""

    SPECS = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3), (256, 3), (256, 3))

    def __init__(self, num_input_frames: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frames = num_input_frames
        self.dtype = dtype
        cins = (3 * num_input_frames,) + tuple(c for c, _ in self.SPECS[:-1])
        self.net = nn.ModuleList(nn.Conv2d(cin, c, k, 2, padding=k // 2)
                                 for cin, (c, k) in zip(cins, self.SPECS))
        self.pose_conv = nn.Conv2d(256, 6 * (num_input_frames - 1), 1)

    def forward(self, x):
        for conv in self.net:
            x = F.relu(conv_nhwc(conv, x, self.dtype))
        x = conv_nhwc(self.pose_conv, x, self.dtype).mean(dim=(1, 2))
        out = 0.01 * x.reshape(-1, self.frames - 1, 1, 6)
        return out[..., :3], out[..., 3:]
