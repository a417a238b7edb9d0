"""Trainability schedules and gated Adam.

Port of `endodav_tpu/train/optim.py`: every main-group parameter gets a
schedule group (`assign_groups`, on the port's parameter names), the step
counter gives each group a 0/1 gate (`schedule_gates`: the DV-LoRA
warm-up switch A/B -> U/V, Dash's ``lora_index`` in its phase 2, the
spatial/temporal LoRA alternation and the depth/pose alternation), and
`GatedAdam` applies torch-semantics Adam in which a gate of 0 leaves the
parameter, its moments and its own step count untouched.

The gate is applied through autograd: `set_trainable` gives a parameter
``requires_grad`` only while its gate is 1, so gated-off parameters get no
gradient (``grad`` None) and `torch.optim.Adam` skips them entirely --
the semantics of JAX's `gated_adam_update`, with per-parameter step
counts, and frozen weights cost no weight-gradient work.
"""

from __future__ import annotations

import torch

__all__ = ["assign_groups", "schedule_gates", "gates_tree", "set_trainable", "GatedAdam"]


def _depth_group(name: str) -> str:
    parts = name.split(".")
    leaf = parts[-1]
    side = "temporal" if any(p.startswith("motion_modules") for p in parts) else "spatial"
    if leaf in ("lora_A", "lora_B"):
        return f"{side}_ab"
    if leaf in ("lora_U", "lora_V"):
        return f"{side}_uv"
    if leaf in ("lora_index", "weight_u_top", "weight_vt_top"):
        return "dash_index" if leaf == "lora_index" else "frozen"
    if any(p.startswith("residual_") or p.startswith("conv_depth_") for p in parts):
        return "adapt"
    if any("output_conv" in p for p in parts):
        return "output_conv"
    return "frozen"


def assign_groups(main_models: dict) -> dict:
    """{component: {param name: group}} for the main components; the depth
    model's parameters by name, every other component's "pose"."""
    return {comp: {name: (_depth_group(name) if comp == "depth_model" else "pose")
                   for name, _ in model.named_parameters()}
            for comp, model in main_models.items()}


def schedule_gates(step: int, cfg: dict, dash_phase2: bool = False) -> dict:
    """Per-group 0/1 gates of global step ``step``, plus ``tune_temporal``
    (the loss-side gate of the temporal depth-consistency terms); Dash's
    ``lora_index`` trains only in its phase 2 (``dash_phase2``)."""
    warm = 0.0 if cfg["lora_type"] == "dvlora" and step > cfg["warm_up_step"] else 1.0
    tdi = cfg["tune_depth_interval"]
    if tdi > 0:
        tune_depth = 1.0 if (step % (2 * tdi)) >= tdi else 0.0
        tune_pose = 1.0 - tune_depth
    else:
        tune_depth = tune_pose = 1.0
    if cfg["temporal_lora"]:
        total = cfg["tune_spatial_interval"] + cfg["tune_temporal_interval"]
        spatial = 1.0 if (step % total) < cfg["tune_spatial_interval"] else 0.0
    else:
        spatial = 1.0
    temporal = 1.0 - spatial if cfg["temporal_lora"] else 0.0
    gates = {
        "spatial_ab": warm * spatial * tune_depth,
        "spatial_uv": (1.0 - warm) * spatial * tune_depth,
        "temporal_ab": warm * temporal * tune_depth,
        "temporal_uv": (1.0 - warm) * temporal * tune_depth,
        "adapt": spatial * tune_depth,
        "output_conv": tune_depth if cfg["train_output_conv"] else 0.0,
        "dash_index": (1.0 if dash_phase2 else 0.0) * spatial * tune_depth,
        "pose": tune_pose,
        "frozen": 0.0,
        "tune_temporal": temporal,
    }
    for grp in cfg.get("legacy_frozen_groups", ()):
        if grp not in gates:
            raise ValueError(f"unknown legacy_frozen_group {grp!r}")
        gates[grp] = 0.0
    return gates


def gates_tree(groups: dict, gates: dict) -> dict:
    """{component: {param name: gate}} from the labels and group gates."""
    return {comp: {name: gates[g] for name, g in names.items()}
            for comp, names in groups.items()}


def set_trainable(models: dict, gate_of: dict | None) -> None:
    """``requires_grad`` = (gate == 1) for every parameter of ``models``;
    ``gate_of`` None freezes them all."""
    for comp, model in models.items():
        for name, p in model.named_parameters():
            p.requires_grad_(gate_of is not None and gate_of[comp][name] == 1.0)


class GatedAdam:
    """torch.optim.Adam (b1 0.9, b2 0.999, eps 1e-8, no decay) over the
    parameters of ``models``; `step(lr)` updates those that got a
    gradient and leaves every other one, with its state, untouched."""

    def __init__(self, models: dict):
        self.params = [p for m in models.values() for p in m.parameters()]
        self.opt = torch.optim.Adam(self.params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()

    def state_of(self, p: torch.Tensor) -> dict:
        return self.opt.state.get(p, {})
