"""EndoDAV — video depth model with temporal attention in the DPT pyramid.

Port of `endodav_tpu/models/endodav.py`: per-frame DINOv2 ViT
(LoRA-adapted MLPs) + the temporal DPTDecoder.  Input [B, T, H, W, 3] in
[0, 1]; bilinear align_corners=True resize to ``image_shape``, ImageNet
normalize, ViT taps at the encoder's intermediate layers, temporal DPT
-> {("disp", s): [B*T, h_s, w_s, 1]}.  Parameter names are the reference
state-dict keys (``pretrained.*``, ``head.*``).

``pos_embedding_type`` ("ape" or "rope") picks the motion modules'
temporal position code, as the JAX field of the same name.

``int8_serving`` (serving only; the engine sets it on the merged vitl
graph) asks the trunk for its int8 GEMMs; ``ENDODAV_INT8`` overrides it.
A shallow copy with the flag changed shares every weight with the
original, the port's counterpart of flax's ``model.clone(int8_serving=
True)``.

``tp_groups`` and ``tp_group`` (JAX :83, :108) make the trunk the local
view of a tensor-parallel split over that process group
(`parallel/tp.py`); the head stays whole.

``dtype`` is the compute dtype of JAX's ``EndoDAV.dtype`` (:120), passed
to the trunk and the head: f32 by default; ``torch.bfloat16`` serves as
the TPU benchmark's headline does (`bench.py:96-105`).  The parameters
stay f32 at either dtype (flax's ``param_dtype``), so the weights of an
f32 model load as they are, and `clone(dtype=torch.bfloat16)` makes the
bf16 model over the same parameter tensors.  `preprocess` stays in the
input's dtype (JAX :158-161).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from endodav_tpu_torch.models.dpt import DPTDecoder
from endodav_tpu_torch.models.lora import dash_phase2_of, set_dash_phase2
from endodav_tpu_torch.models.vit import VIT_CONFIGS, DinoViT
from endodav_tpu_torch.ops.resize import resize2d

__all__ = ["EndoDAV", "ENDODAV_CONFIGS", "INFER_LEN", "OVERLAP", "KEYFRAMES", "INTERP_LEN",
           "IMAGENET_MEAN", "IMAGENET_STD", "endodav_lora_alpha", "prefix_map_shapes"]

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
    """lora alpha=2r, dvlora alpha=r, dash alpha=2r (endodav.py:107-118 of
    the reference); None, the layers' default 2r, for the others."""
    return {"lora": 2.0 * r, "dvlora": float(r), "dash": 2.0 * r}.get(lora_type)


def prefix_map_shapes(model: "EndoDAV"):
    """Per-frame shapes [H, W, C] of `decode_prefix`'s four maps
    (layer_1_rn, layer_2_rn, layer_3, layer_4) for ``model``'s config."""
    ph, pw = model.patch_hw
    cfg = ENDODAV_CONFIGS[model.encoder]
    f, oc = cfg["features"], cfg["out_channels"]
    return ((4 * ph, 4 * pw, f), (2 * ph, 2 * pw, f), (ph, pw, oc[2]),
            # layer_4: conv k=3 s=2 with (1,1) padding on the patch grid
            ((ph - 1) // 2 + 1, (pw - 1) // 2 + 1, oc[3]))


class EndoDAV(nn.Module):
    model_type = "endodav"

    def __init__(self, encoder: str = "vits", r: int = 4,
                 image_shape: tuple[int, int] = (224, 280), lora_type: str = "dvlora",
                 residual_block_indexes: Sequence[int] = (), include_cls_token: bool = True,
                 num_frames: int = 32, inv_sigmoid: bool = False, temporal_lora: bool = False,
                 conv_head: bool = True, out_sigmoid: bool = False,
                 int8_serving: bool = False, pos_embedding_type: str = "ape",
                 dtype: torch.dtype = torch.float32, tp_groups: int = 1, tp_group=None):
        super().__init__()
        self.config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        self.encoder = encoder
        self.dtype = dtype
        self.lora_type = lora_type
        self.int8_serving = int8_serving
        self.image_shape = tuple(image_shape)
        cfg = ENDODAV_CONFIGS[encoder]
        vit_cfg = VIT_CONFIGS[encoder]
        alpha = endodav_lora_alpha(lora_type, r)
        self.pretrained = DinoViT(
            **vit_cfg, residual_block_indexes=tuple(residual_block_indexes),
            include_cls_token=include_cls_token, lora_variant=lora_type, lora_rank=r,
            lora_alpha=alpha, dtype=dtype, tp_groups=tp_groups, tp_group=tp_group)
        self.head = DPTDecoder(
            in_channels=vit_cfg["embed_dim"], features=cfg["features"],
            out_channels=cfg["out_channels"], num_frames=num_frames, conv_head=conv_head,
            inv_sigmoid=inv_sigmoid, out_sigmoid=out_sigmoid,
            temporal_lora_variant=lora_type if temporal_lora else "none", lora_rank=r,
            lora_alpha=alpha, pos_embedding_type=pos_embedding_type, dtype=dtype)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def clone(self, **changes) -> "EndoDAV":
        """This model with constructor arguments changed (flax's
        ``Module.clone``), over the same parameter tensors, on the same
        device and in the same Dash phase: ``model.clone(dtype=
        torch.bfloat16)`` serves these weights in bf16."""
        device = next(self.parameters()).device
        model = EndoDAV(**{**self.config, "int8_serving": self.int8_serving, **changes})
        model.load_state_dict(self.state_dict(), strict=True, assign=True)
        set_dash_phase2(model, dash_phase2_of(self))
        return model.to(device).train(self.training)

    @property
    def patch_hw(self) -> tuple[int, int]:
        return self.image_shape[0] // 14, self.image_shape[1] // 14

    def preprocess(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B*T, h, w, 3] trunk input."""
        x = video.reshape(-1, *video.shape[2:])
        x = resize2d(x, self.image_shape, "bilinear", align_corners=True)
        return (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)

    def encode(self, video: torch.Tensor):
        take = ENDODAV_CONFIGS[self.encoder]["intermediate"]
        return self.pretrained(self.preprocess(video), take, self.int8_serving)

    def decode(self, taps, frames: int, train: bool = False):
        return self.head(taps, self.patch_hw, frames=frames, train=train)

    def decode_prefix(self, taps):
        """Per-frame front half of the DPT head (no op mixes frames): the
        dedup pipeline runs it once per unique source frame."""
        return self.head.prefix(taps, self.patch_hw)

    def decode_suffix(self, maps, frames: int, train: bool = False):
        """Window half of the DPT head: temporal modules, fusion pyramid, heads."""
        return self.head.suffix(maps, frames, train)

    def forward(self, video: torch.Tensor, train: bool = False):
        """``train`` selects the motion modules' training route, as the JAX
        ``EndoDAV.__call__(video, train)``; gradients flow either way."""
        return self.decode(self.encode(video), video.shape[1], train)
