"""Legacy AF-SfMLearner depth model (``model_type=afsfm``).

Port of `endodav_tpu/models/afsfm.py`: a ResNet encoder and the
monodepth2 sigmoid-disparity U-Net (`models/decoders.py:DepthDecoder`).
No internal resize: the U-Net takes images at the dataset resolution,
which the ResNet's /32 stride chain must divide.  Its weights ship as two
reference files, ``encoder.pth`` (keys ``encoder.*`` of ``self.encoder``)
and ``depth.pth`` (keys ``convs.*`` of ``self.depth``).  BatchNorm runs on
its running statistics at serving; in train mode (JAX :27-33) on the batch's,
which it records as pending (`models/resnet.py:BatchNorm`).  ``dtype`` is
JAX's compute dtype, passed to the encoder and the U-Net.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from endodav_tpu_torch.models.decoders import DepthDecoder
from endodav_tpu_torch.models.resnet import ResNetEncoder, resnet_num_ch_enc

__all__ = ["AFSfMDepth"]


class AFSfMDepth(nn.Module):
    model_type = "afsfm"

    def __init__(self, num_layers: int = 18, scales: Sequence[int] = (0, 1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetEncoder(num_layers, dtype=dtype)
        self.depth = DepthDecoder(resnet_num_ch_enc(num_layers), tuple(scales), dtype=dtype)

    def forward(self, pixels: torch.Tensor, train: bool = False):
        if pixels.ndim == 5:
            pixels = pixels.reshape(-1, *pixels.shape[2:])
        return self.depth(self.encoder(pixels, train))
