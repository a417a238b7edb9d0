"""EndoDAC — single-frame LoRA-adapted ViT depth model.

Port of `endodav_tpu/models/endodac.py`: the DINOv2 ViT-S/B trunk with
LoRA-adapted MLPs feeding a non-temporal DPT head with four sigmoid
HeadDepth outputs.  Input [B, H, W, 3] in [0, 1] (a 5-D video input is
flattened to its frames), bilinear align_corners=True resize to
``image_shape``, ImageNet normalize only with ``pre_norm`` (off by
default), the ViT taps of the last four blocks (8, 9, 10, 11) at both
sizes, DPT -> {("disp", s): [B, h_s, w_s, 1]}.  Parameter names are the
reference state-dict keys (``pretrained.*``, ``depth_head.*``).

``dtype`` is the compute dtype of JAX's ``EndoDAC.dtype``, passed to the
trunk and the head at the cast points of `models/cast.py`; parameters
stay f32 and ``clone(dtype=torch.bfloat16)`` serves the same tensors in
bf16.  The resize and ``pre_norm`` stay in the input's dtype.

Adapters: every variant of `models/lora.py`.  ``train`` reaches the
head, where it only matters with ``use_bn`` (batch statistics, recorded
as pending) and for the fused RCU route (serving only).  Not ported: the
JAX fields ``tp_groups`` and ``scan_trunk`` (tensor parallelism and XLA's
compile of the trunk).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from endodav_tpu_torch.models.dpt import DPTDecoder
from endodav_tpu_torch.models.endodav import IMAGENET_MEAN, IMAGENET_STD
from endodav_tpu_torch.models.lora import dash_phase2_of, set_dash_phase2
from endodav_tpu_torch.models.vit import VIT_CONFIGS, DinoViT
from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["EndoDAC", "ENDODAC_CONFIGS", "endodac_lora_alpha"]

# DINOv2's get_intermediate_layers(4) takes the last four blocks at both
# 12-block sizes (JAX models/endodac.py:31-36)
ENDODAC_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384), intermediate=(8, 9, 10, 11)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768), intermediate=(8, 9, 10, 11)),
}


def endodac_lora_alpha(lora_type: str, r: int) -> float | None:
    """lora keeps alpha 1, dvlora uses alpha r (JAX endodac.py:41-44); None,
    the layers' default 2r, for the others (dash included)."""
    return {"lora": 1.0, "dvlora": float(r)}.get(lora_type)


class EndoDAC(nn.Module):
    model_type = "endodac"

    def __init__(self, backbone_size: str = "vits", r: int = 4,
                 image_shape: tuple[int, int] = (224, 280), lora_type: str = "lora",
                 residual_block_indexes: Sequence[int] = (), include_cls_token: bool = True,
                 use_cls_token: bool = False, use_bn: bool = False, pre_norm: bool = False,
                 inv_sigmoid: bool = False, conv_head: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        self.backbone_size = backbone_size
        self.lora_type = lora_type
        self.image_shape = tuple(image_shape)
        self.pre_norm = pre_norm
        self.dtype = dtype
        cfg = ENDODAC_CONFIGS[backbone_size]
        vit_cfg = VIT_CONFIGS[backbone_size]
        self.take = cfg["intermediate"]
        self.pretrained = DinoViT(
            **vit_cfg, residual_block_indexes=tuple(residual_block_indexes),
            include_cls_token=include_cls_token, lora_variant=lora_type, lora_rank=r,
            lora_alpha=endodac_lora_alpha(lora_type, r), dtype=dtype)
        self.depth_head = DPTDecoder(
            in_channels=vit_cfg["embed_dim"], features=cfg["features"],
            out_channels=cfg["out_channels"], conv_head=conv_head, inv_sigmoid=inv_sigmoid,
            dtype=dtype, temporal=False, use_bn=use_bn, use_clstoken=use_cls_token)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def clone(self, **changes) -> "EndoDAC":
        """This model with constructor arguments changed (flax's
        ``Module.clone``), over the same parameter tensors and on the same
        device, in the same Dash phase."""
        device = next(self.parameters()).device
        model = EndoDAC(**{**self.config, **changes})
        model.load_state_dict(self.state_dict(), strict=True, assign=True)
        set_dash_phase2(model, dash_phase2_of(self))
        return model.to(device).train(self.training)

    @property
    def patch_hw(self) -> tuple[int, int]:
        return self.image_shape[0] // 14, self.image_shape[1] // 14

    def forward(self, pixels: torch.Tensor, train: bool = False):
        if pixels.ndim == 5:
            pixels = pixels.reshape(-1, *pixels.shape[2:])
        x = resize2d(pixels, self.image_shape, "bilinear", align_corners=True)
        if self.pre_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        taps = self.pretrained(x, self.take)
        return self.depth_head(taps, self.patch_hw, frames=1, train=train)
