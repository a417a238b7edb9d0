"""EndoDAV — video depth model with temporal attention in the DPT pyramid.

Port of `endodav_tpu/models/endodav.py`: per-frame DINOv2 ViT
(LoRA-adapted MLPs) + the temporal DPTDecoder.  Input [B, T, H, W, 3] in
[0, 1]; bilinear align_corners=True resize to ``image_shape``, ImageNet
normalize, ViT taps at the encoder's intermediate layers, temporal DPT
-> {("disp", s): [B*T, h_s, w_s, 1]}.  Parameter names are the reference
state-dict keys (``pretrained.*``, ``head.*``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from endodav_tpu_torch.models.dpt import DPTDecoder
from endodav_tpu_torch.models.vit import VIT_CONFIGS, DinoViT
from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["EndoDAV", "ENDODAV_CONFIGS", "INFER_LEN", "OVERLAP", "KEYFRAMES", "INTERP_LEN",
           "IMAGENET_MEAN", "IMAGENET_STD", "endodav_lora_alpha"]

# Sliding-window inference constants.
INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = (6, 12, 24, 25, 26, 27, 28, 29, 30, 31)
INTERP_LEN = 8

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

ENDODAV_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384), intermediate=(2, 5, 8, 11)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024), intermediate=(4, 11, 17, 23)),
}


def endodav_lora_alpha(lora_type: str, r: int) -> float | None:
    """lora alpha=2r, dvlora alpha=r (endodav.py:107-118 of the reference)."""
    return {"lora": 2.0 * r, "dvlora": float(r)}.get(lora_type)


class EndoDAV(nn.Module):
    def __init__(self, encoder: str = "vits", r: int = 4,
                 image_shape: tuple[int, int] = (224, 280), lora_type: str = "dvlora",
                 residual_block_indexes: Sequence[int] = (), include_cls_token: bool = True,
                 num_frames: int = 32, inv_sigmoid: bool = False, temporal_lora: bool = False,
                 conv_head: bool = True, out_sigmoid: bool = False):
        super().__init__()
        self.encoder = encoder
        self.image_shape = tuple(image_shape)
        cfg = ENDODAV_CONFIGS[encoder]
        vit_cfg = VIT_CONFIGS[encoder]
        alpha = endodav_lora_alpha(lora_type, r)
        self.pretrained = DinoViT(
            **vit_cfg, residual_block_indexes=tuple(residual_block_indexes),
            include_cls_token=include_cls_token, lora_variant=lora_type, lora_rank=r,
            lora_alpha=alpha)
        self.head = DPTDecoder(
            in_channels=vit_cfg["embed_dim"], features=cfg["features"],
            out_channels=cfg["out_channels"], num_frames=num_frames, conv_head=conv_head,
            inv_sigmoid=inv_sigmoid, out_sigmoid=out_sigmoid,
            temporal_lora_variant=lora_type if temporal_lora else "none", lora_rank=r,
            lora_alpha=alpha)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    @property
    def patch_hw(self) -> tuple[int, int]:
        return self.image_shape[0] // 14, self.image_shape[1] // 14

    def preprocess(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B*T, h, w, 3] trunk input."""
        x = video.reshape(-1, *video.shape[2:])
        x = resize2d(x, self.image_shape, "bilinear", align_corners=True)
        return (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)

    def encode(self, video: torch.Tensor):
        return self.pretrained(self.preprocess(video), ENDODAV_CONFIGS[self.encoder]["intermediate"])

    def decode(self, taps, frames: int):
        return self.head(taps, self.patch_hw, frames=frames)

    def forward(self, video: torch.Tensor):
        return self.decode(self.encode(video), video.shape[1])
