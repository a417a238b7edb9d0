"""Low-rank adapted Linear layers and the serving-time merge.

Port of `endodav_tpu/models/lora.py` for the variants the serving path
needs: ``none``, ``lora`` and ``dvlora`` (the CLI default).  Parameter
names follow the reference's state-dict keys: ``weight`` [out, in],
``bias`` [out], ``lora_A`` [r, in], ``lora_B`` [out, r], and for DV-LoRA
``lora_U`` [r, 1] and ``lora_V`` [out, 1].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.ops.quant import int8_dense

__all__ = ["LoRADense", "merge_lora_params", "VARIANTS"]

VARIANTS = ("none", "lora", "dvlora")


class LoRADense(nn.Module):
    """Linear layer with a frozen base weight and a low-rank delta.

    * "none"   — plain linear
    * "lora"   — y += x A^T B^T * alpha/r
    * "dvlora" — y += x (A∘U)^T (B∘V)^T * alpha/r
    """

    def __init__(self, in_features: int, out_features: int, r: int = 4,
                 lora_alpha: float | None = None, variant: str = "lora"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"LoRA variant {variant!r} is not ported (ported: {VARIANTS})")
        self.variant = variant
        self.r = r
        self.scaling = (lora_alpha if lora_alpha is not None else 2.0 * r) / r
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        if variant != "none":
            self.lora_A = nn.Parameter(torch.empty(r, in_features))
            self.lora_B = nn.Parameter(torch.zeros(out_features, r))
        if variant == "dvlora":
            self.lora_U = nn.Parameter(torch.empty(r, 1))
            self.lora_V = nn.Parameter(torch.empty(out_features, 1))

    def forward(self, x: torch.Tensor, quant_int8: bool = False) -> torch.Tensor:
        """``quant_int8`` (resolved by the caller) routes the plain layer
        through the int8 serving GEMM; adapted variants ignore it."""
        if self.variant == "none" and quant_int8:
            return int8_dense(x, self.weight, self.bias)
        y = F.linear(x, self.weight, self.bias)
        if self.variant == "none":
            return y
        a, b = self.lora_A, self.lora_B
        if self.variant == "dvlora":
            a, b = a * self.lora_U, b * self.lora_V
        return y + F.linear(F.linear(x, a), b) * self.scaling


def merge_lora_params(state_dict: dict[str, torch.Tensor], variant: str, r: int,
                      alpha: float | None = None) -> dict[str, torch.Tensor]:
    """Fold every LoRA delta into its base weight (exact at f32).

    Returns a state dict in which each adapted layer carries only
    ``weight``/``bias`` — what a model built with ``lora_type='none'``
    expects.
    """
    if variant == "none":
        return dict(state_dict)
    if variant not in VARIANTS:
        raise ValueError(f"LoRA variant {variant!r} is not ported (ported: {VARIANTS})")
    scaling = (alpha if alpha is not None else 2.0 * r) / r
    out = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf.startswith("lora_"):
            continue
        a_key = f"{prefix}.lora_A" if prefix else "lora_A"
        if leaf == "weight" and a_key in state_dict:
            pre = f"{prefix}." if prefix else ""
            a = state_dict[a_key].float()
            b = state_dict[pre + "lora_B"].float()
            if variant == "dvlora":
                a = a * state_dict[pre + "lora_U"].float()
                b = b * state_dict[pre + "lora_V"].float()
            value = (value.float() + (b @ a) * scaling).to(value.dtype)
        out[key] = value
    return out
