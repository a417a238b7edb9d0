"""ResNet feature-pyramid encoder of the pose, position and transform nets.

Port of `endodav_tpu/models/resnet.py` (ResNet-18/34 of basic blocks,
ResNet-50/101/152 of bottleneck blocks, `num_input_images` frames stacked
on the channel axis): channels-last input [B, H, W, 3n] ->
[relu(bn1(conv1)), layer1, layer2, layer3, layer4], with
`resnet_num_ch_enc` channels.  Parameter names are the reference's
torchvision keys under ``encoder.`` (``encoder.layer1.0.conv1.weight``,
``encoder.layer1.0.conv3.weight``, ``encoder.layer2.0.downsample.0.weight``
...).

BatchNorm is flax's (`resnet.py:42,66,98`: momentum 0.9, eps 1e-5), not
`nn.BatchNorm2d`'s: in train mode the batch mean and the *biased* batch
variance (E[x^2] - E[x]^2, clipped at 0, as flax's fast variance)
normalise, and the running update is ``0.9 * old + 0.1 * batch`` with that
same variance.  A train-mode call only records its batch statistics;
`commit_batch_stats` applies the update, so when a step applies an
encoder several times only the last application's statistics are stored
(`endodav_tpu/train/trainer.py:19-21`); `discard_batch_stats` drops them
where JAX's step throws the new statistics away (the depth model's).

``dtype`` is the compute dtype of JAX's ``ResNetEncoder.dtype``: every
convolution casts its input and kernel to it (`models/cast.py`).  JAX's
BatchNorms take no ``dtype``, so flax promotes their output with the f32
scale and bias: statistics and output are f32 whatever the convolution
gave, and with them the five feature maps.  At f32 every cast is the
identity.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.models.cast import conv_nhwc

__all__ = ["BatchNorm", "ResNetEncoder", "resnet_num_ch_enc", "commit_batch_stats",
           "discard_batch_stats"]

_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
           152: (3, 8, 36, 3)}
_BOTTLENECK = {50, 101, 152}
MOMENTUM = 0.9
EPS = 1e-5


def resnet_num_ch_enc(num_layers: int) -> tuple[int, ...]:
    """The five maps' channels; a bottleneck's output is 4x its width."""
    if num_layers not in _LAYERS:
        raise ValueError(f"ResNet-{num_layers} does not exist (choices: {sorted(_LAYERS)})")
    base = (64, 64, 128, 256, 512)
    if num_layers in _BOTTLENECK:
        return (64,) + tuple(4 * c for c in base[1:])
    return base


class BatchNorm(nn.Module):
    """flax-semantics BatchNorm over the channel axis of [B, H, W, C]; the
    output is f32 (flax's ``dtype=None`` promotes it with the f32 scale)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.pending = None  # (mean, var) of the last train-mode call

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            xf = x.float()
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            self.pending = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + EPS) * self.weight) + self.bias

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the last train-mode call's statistics into the running ones."""
        if self.pending is not None:
            mean, var = self.pending
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
            self.pending = None


def commit_batch_stats(module: nn.Module) -> None:
    """Apply every pending BatchNorm update inside ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.commit()


def discard_batch_stats(module: nn.Module) -> None:
    """Drop every pending BatchNorm update inside ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.pending = None


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        # torch 3x3/s2 convs pad (1, 1) on both sides, as the JAX block does
        self.conv1 = nn.Conv2d(cin, features, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        if cin != features or stride != 1:
            self.downsample = nn.ModuleList([nn.Conv2d(cin, features, 1, stride, bias=False),
                                             BatchNorm(features)])

    def forward(self, x, train: bool):
        dt = self.dtype
        y = F.relu(self.bn1(conv_nhwc(self.conv1, x, dt), train))
        y = self.bn2(conv_nhwc(self.conv2, y, dt), train)
        if hasattr(self, "downsample"):
            conv, bn = self.downsample
            x = bn(conv_nhwc(conv, x, dt), train)
        return F.relu(y + x)


class Bottleneck(nn.Module):
    """JAX's `_Bottleneck` (:59-80): 1x1 to ``features``, 3x3 with the
    stride, 1x1 to ``4 * features``; a projection where the width or the
    stride changes."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        out_ch = features * self.expansion
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        if cin != out_ch or stride != 1:
            self.downsample = nn.ModuleList([nn.Conv2d(cin, out_ch, 1, stride, bias=False),
                                             BatchNorm(out_ch)])

    def forward(self, x, train: bool):
        dt = self.dtype
        y = F.relu(self.bn1(conv_nhwc(self.conv1, x, dt), train))
        y = F.relu(self.bn2(conv_nhwc(self.conv2, y, dt), train))
        y = self.bn3(conv_nhwc(self.conv3, y, dt), train)
        if hasattr(self, "downsample"):
            conv, bn = self.downsample
            x = bn(conv_nhwc(conv, x, dt), train)
        return F.relu(y + x)


class _Trunk(nn.Module):
    def __init__(self, num_layers: int, in_ch: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        block = Bottleneck if num_layers in _BOTTLENECK else BasicBlock
        cin = 64
        for stage, (width, nblocks) in enumerate(zip((64, 128, 256, 512), _LAYERS[num_layers]),
                                                 start=1):
            blocks = []
            for b in range(nblocks):
                blocks.append(block(cin, width, 2 if (stage > 1 and b == 0) else 1, dtype))
                cin = width * block.expansion
            setattr(self, f"layer{stage}", nn.ModuleList(blocks))


class ResNetEncoder(nn.Module):
    """``forward(x [B, H, W, 3 * num_input_images], train)`` -> 5 maps."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        resnet_num_ch_enc(num_layers)
        self.dtype = dtype
        self.encoder = _Trunk(num_layers, 3 * num_input_images, dtype)

    def forward(self, x: torch.Tensor, train: bool = False):
        e = self.encoder
        y = F.relu(e.bn1(conv_nhwc(e.conv1, x, self.dtype), train))
        features = [y]
        # maxpool 3x3 stride 2 pad 1 (-inf padding)
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        for stage in range(1, 5):
            for blk in getattr(e, f"layer{stage}"):
                y = blk(y, train)
            features.append(y)
        return features
