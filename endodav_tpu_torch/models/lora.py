"""Low-rank adapted layers, the Dash phase boundary and the serving-time merge.

Port of `endodav_tpu/models/lora.py`, every variant of its ``LoRADense``
(``none``, ``lora``, ``dvlora``, ``ssb``, ``dash``, ``galora``, ``flora``),
`LoRAConv`, `LoRAEmbed`, `dash_svd_update` and `merge_lora_params`.
Parameter names follow the reference's state-dict keys: ``weight`` [out,
in], ``bias`` [out], ``lora_A`` [r, in], ``lora_B`` [out, r]; DV-LoRA's
``lora_U`` [r, 1] and ``lora_V`` [out, 1]; ssb's ``lora_A`` [in, 1] and
``lora_B`` [out, 1] (``Linear_SSB``'s column vectors); flora's ``lora_E``
[r, r]; Dash's ``lora_index`` [8], ``weight_u_top`` [out, 8] and
``weight_vt_top`` [8, in].

``dtype`` is the compute dtype of the JAX field of the same name: the
parameters stay f32, the input and the (f32-formed) adapter factors are
cast to it.  ``none`` and ``ssb`` return the compute dtype, every other
variant its input's dtype (JAX `models/lora.py:84-147`).  The merge stays
in f32.

Dash's phase is a switch on the layer (``dash_phase2``, set model-wide by
`set_dash_phase2`) where JAX threads an argument through every forward;
the serving call sites stay as they are, which is what JAX's
``_DashPhase2Model`` does for its engine.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from endodav_tpu_torch.ops.quant import int8_dense

__all__ = ["LoRADense", "LoRAConv", "LoRAEmbed", "dash_svd_update", "merge_lora_params",
           "set_dash_phase2", "dash_phase2_of", "VARIANTS"]

VARIANTS = ("none", "lora", "dvlora", "ssb", "dash", "galora", "flora")
DASH_INDEX = 8  # singular directions a Dash layer keeps (mylora DashLinear's index)
# the adapter leaves a merge folds away (JAX merge_lora_params :265-266)
_ADAPTER_KEYS = ("lora_A", "lora_B", "lora_U", "lora_V", "lora_E", "lora_index",
                 "weight_u_top", "weight_vt_top")


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown lora variant: {variant!r} (variants: {VARIANTS})")


class LoRADense(nn.Module):
    """Linear layer with a frozen base weight and a low-rank delta.

    * "none"   — plain linear
    * "lora"   — y += x A^T B^T * alpha/r
    * "dvlora" — y += x (A∘U)^T (B∘V)^T * alpha/r
    * "ssb"    — the weight scaled per row and column: W' = B ⊙ W ⊙ A^T
    * "dash"   — lora, plus in phase 2 x ((U_top · diag(index)) Vt_top)^T
    * "galora" — the lora delta through a SiLU gate: delta * sigmoid(delta)
    * "flora"  — y += x A^T E^T B^T * alpha/(r + 1e-5)
    """

    def __init__(self, in_features: int, out_features: int, r: int = 4,
                 lora_alpha: float | None = None, variant: str = "lora",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_variant(variant)
        self.dtype = dtype
        self.variant = variant
        self.r = r
        self.dash_phase2 = False
        alpha = lora_alpha if lora_alpha is not None else 2.0 * r
        self.scaling = ((alpha if alpha > 0 else float(r)) / (r + 1e-5) if variant == "flora"
                        else alpha / r)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        if variant == "ssb":
            self.lora_A = nn.Parameter(torch.ones(in_features, 1))
            self.lora_B = nn.Parameter(torch.ones(out_features, 1))
        elif variant != "none":
            self.lora_A = nn.Parameter(torch.empty(r, in_features))
            self.lora_B = nn.Parameter(torch.zeros(out_features, r))
        if variant == "dvlora":
            self.lora_U = nn.Parameter(torch.empty(r, 1))
            self.lora_V = nn.Parameter(torch.empty(out_features, 1))
        elif variant == "flora":
            self.lora_E = nn.Parameter(torch.zeros(r, r))
        elif variant == "dash":
            self.lora_index = nn.Parameter(torch.zeros(DASH_INDEX))
            self.weight_u_top = nn.Parameter(torch.zeros(out_features, DASH_INDEX))
            self.weight_vt_top = nn.Parameter(torch.zeros(DASH_INDEX, in_features))

    def forward(self, x: torch.Tensor, quant_int8: bool = False) -> torch.Tensor:
        """``quant_int8`` (resolved by the caller) routes the plain layer
        through the int8 serving GEMM; adapted variants ignore it."""
        dt = self.dtype
        xd = x.to(dt)
        if self.variant == "ssb":
            # JAX's (a * kernel) * b, product by product
            w = self.weight * self.lora_A.t() * self.lora_B
            return F.linear(xd, w.to(dt), self.bias.to(dt))
        if self.variant == "none" and quant_int8:
            return int8_dense(xd, self.weight, self.bias, out_dtype=dt)
        y = F.linear(xd, self.weight.to(dt), self.bias.to(dt))
        if self.variant == "none":
            return y
        a, b = self.lora_A, self.lora_B
        if self.variant == "flora":
            delta = F.linear(F.linear(F.linear(xd, a.to(dt)), self.lora_E.to(dt)), b.to(dt))
            return (y + delta * self.scaling).to(x.dtype)
        if self.variant == "dvlora":
            a, b = a * self.lora_U, b * self.lora_V
        delta = F.linear(F.linear(xd, a.to(dt)), b.to(dt)) * self.scaling
        if self.variant == "galora":
            return (y + delta * torch.sigmoid(delta)).to(x.dtype)
        y = y + delta
        if self.variant == "dash" and self.dash_phase2:
            top = (self.weight_u_top * self.lora_index) @ self.weight_vt_top  # [out, in]
            y = y + F.linear(xd, top.to(dt))
        return y.to(x.dtype)


def _same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class LoRAConv(nn.Module):
    """Conv2d over channels-last [B, H, W, C] with a low-rank kernel delta
    (mylora Conv2d :264-322): ``lora_B`` [out*k, r*k] @ ``lora_A`` [r*k,
    in*k], reshaped to the [out, in, k, k] weight, times alpha/r; "SAME"
    padding as the JAX module's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, r: int = 4,
                 lora_alpha: float = 1.0, stride: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.stride, self.dtype = stride, dtype
        self.scaling = lora_alpha / r
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.lora_A = nn.Parameter(torch.empty(r * k, in_channels * k))
        self.lora_B = nn.Parameter(torch.zeros(out_channels * k, r * k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        k = self.weight.shape[-1]
        w = self.weight + (self.lora_B @ self.lora_A).reshape(self.weight.shape) * self.scaling
        (top, bottom), (left, right) = (_same_padding(n, k, self.stride) for n in x.shape[1:3])
        xc = F.pad(x.to(dt).permute(0, 3, 1, 2), (left, right, top, bottom))
        y = F.conv2d(xc, w.to(dt), None, self.stride).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y.to(x.dtype)


class LoRAEmbed(nn.Module):
    """Embedding with a low-rank delta (mylora Embedding :32-89): the
    table row plus ``lora_A``'s column times ``lora_B``, times alpha/r.
    The table keeps JAX's name, ``embedding``, which is what marks it for
    `merge_lora_params`."""

    def __init__(self, num_embeddings: int, features: int, r: int = 4,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scaling = lora_alpha / r
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.lora_A = nn.Parameter(torch.zeros(r, num_embeddings))
        self.lora_B = nn.Parameter(torch.empty(features, r))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        delta = F.linear(self.lora_A.t()[ids], self.lora_B) * self.scaling
        return (self.embedding[ids] + delta).to(self.dtype)


def set_dash_phase2(model: nn.Module, on: bool) -> nn.Module:
    """Switch every `LoRADense` of ``model`` to Dash's phase 2 (the
    ``lora_index`` term on the frozen top singular directions) or back."""
    for m in model.modules():
        if isinstance(m, LoRADense):
            m.dash_phase2 = bool(on)
    return model


def dash_phase2_of(model: nn.Module) -> bool:
    """Whether ``model``'s Dash layers are in phase 2."""
    return any(m.dash_phase2 for m in model.modules() if isinstance(m, LoRADense))


@torch.no_grad()
def dash_svd_update(model: nn.Module, scaling: float | None = None) -> nn.Module:
    """Dash's phase boundary (mylora/layers.py:568-578), in place: for every
    Dash layer, SVD the frozen weight, rank the singular directions by
    |Δσ|/|σ| of the current LoRA delta (scaled by ``scaling``, default 2)
    and fill ``weight_u_top`` / ``weight_vt_top`` with the top ones.  On the
    host in numpy f32, with JAX's own calls, so the ranking is JAX's."""
    s = scaling if scaling is not None else 2.0
    for m in model.modules():
        if not (isinstance(m, LoRADense) and m.variant == "dash"):
            continue
        w = m.weight.detach().cpu().numpy().astype(np.float32)  # (out, in)
        a = m.lora_A.detach().cpu().numpy().astype(np.float32)
        b = m.lora_B.detach().cpu().numpy().astype(np.float32)
        delta_w = (b @ a) * s
        u, sigma, vt = np.linalg.svd(w, full_matrices=False)
        delta_sigma = np.diag(u.T @ delta_w @ vt.T)
        change_rate = np.abs(delta_sigma) / np.abs(sigma)
        top = np.argsort(-change_rate)[: m.weight_u_top.shape[1]]
        m.weight_u_top.copy_(torch.from_numpy(np.ascontiguousarray(u[:, top])))
        m.weight_vt_top.copy_(torch.from_numpy(np.ascontiguousarray(vt[top, :])))
    return model


def merge_lora_params(state_dict: dict[str, torch.Tensor], variant: str, r: int,
                      alpha: float | None = None,
                      dash_phase2: bool = False) -> dict[str, torch.Tensor]:
    """Fold every low-rank delta into its base weight (exact at f32).

    Returns a state dict in which each adapted layer carries only
    ``weight``/``bias`` (a `LoRAEmbed` only ``embedding``) — what a model
    built with ``lora_type='none'`` expects.  ``variant``, ``r`` and
    ``alpha`` are the model-wide settings; the dense rule follows
    ``variant`` (an r=1 lora's ``lora_B`` has ssb's shape), a 4-D weight
    is a `LoRAConv` and an ``embedding`` a `LoRAEmbed`, both with alpha
    1 unless one is given.  Dash adds its phase-2 term with
    ``dash_phase2``.  galora's delta is gated by the input and raises.
    """
    _check_variant(variant)
    if variant == "galora":
        raise ValueError("galora deltas are input-gated and cannot be merged")
    if variant == "none":
        return dict(state_dict)
    al = alpha if alpha is not None else 2.0 * r
    al_table = alpha if alpha is not None else 1.0  # LoRAConv, LoRAEmbed
    out = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        pre = f"{prefix}." if prefix else ""
        adapted = pre + "lora_A" in state_dict
        if adapted and leaf in _ADAPTER_KEYS:
            continue
        if adapted and leaf in ("weight", "embedding"):
            w = value.float()
            a = state_dict[pre + "lora_A"].float()
            b = state_dict[pre + "lora_B"].float()
            if leaf == "embedding":
                merged = w + (a.t() @ b.t()) * (al_table / r)
            elif w.ndim == 4:
                merged = w + (b @ a).reshape(w.shape) * (al_table / r)
            elif variant == "ssb":
                merged = w * a.t() * b
            elif variant == "flora":
                scale = (al if al > 0 else float(r)) / (r + 1e-5)
                merged = w + (b @ state_dict[pre + "lora_E"].float() @ a) * scale
            else:
                if variant == "dvlora":
                    a = a * state_dict[pre + "lora_U"].float()
                    b = b * state_dict[pre + "lora_V"].float()
                merged = w + (b @ a) * (al / r)
                if variant == "dash" and dash_phase2:
                    u_top = state_dict[pre + "weight_u_top"].float()
                    idx = state_dict[pre + "lora_index"].float()
                    merged = merged + (u_top * idx) @ state_dict[pre + "weight_vt_top"].float()
            value = merged.to(value.dtype)
        out[key] = value
    return out
