"""The self-supervised video training step.

Port of `endodav_tpu/train/trainer.py`: `build_models` (the eight
components), a seeded initialisation, the two gated-Adam optimizers (main
lr ``--learning_rate``, position nets 1e-4, both x0.1 every
``--scheduler_step_size`` epochs), the schedule gates, `loss_cfg`, the
step (`step_fn`, trainer.py:354-474, run eagerly), `train_one_batch` and
`run_epoch`.  The step runs phase 0 (the position nets on
`position_phase_loss`) and then the main phase (depth, pose, transform
and intrinsics nets on `main_phase`), each with its own backward pass and
Adam update, as the JAX step does inside one jit.

Everything runs on the CUDA card unless ``--no_cuda`` asks for the CPU;
finding no card is an error.  Not ported yet: `val`, `run_epoch_eval`,
`train`, checkpoint save/load, TensorBoard logging, ``--random_train``,
``--host_preprocess``, the dash phase, ssb, the data-parallel mesh and
bf16 training.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from endodav_tpu_torch.data.loader import Loader, readlines
from endodav_tpu_torch.data.scared import ScaredVideoClips
from endodav_tpu_torch.eval.engine import SPLITS_DIR, resolve_device
from endodav_tpu_torch.models.decoders import (IntrinsicsHead, PoseDecoder, PositionDecoder,
                                               TransformDecoder)
from endodav_tpu_torch.models.endodav import EndoDAV
from endodav_tpu_torch.models.resnet import ResNetEncoder, commit_batch_stats, resnet_num_ch_enc
from endodav_tpu_torch.ops.jitter import device_pyramid
from endodav_tpu_torch.train import losses as L
from endodav_tpu_torch.train import optim as O
from endodav_tpu_torch.utils.convert import load_reference_pth
from endodav_tpu_torch.utils.precision import set_f32_policy

__all__ = ["Trainer", "build_models", "init_train_", "MAIN_COMPONENTS", "POSITION_COMPONENTS"]

MAIN_COMPONENTS = ("depth_model", "transform_encoder", "transform", "pose_encoder", "pose",
                   "intrinsics_head")
POSITION_COMPONENTS = ("position_encoder", "position")
FRAME_IDS = (0, -1, 1)
# keys of the device-preprocess batch that stay per item and on the host
_HOST_KEYS = (("frame_window_map",), ("jitter_order",), ("jitter_factors",))


def build_models(opt) -> dict:
    """The eight components of the video trainer (trainer.py:59-134)."""
    if opt.model_type != "endodav":
        raise ValueError(f"model_type {opt.model_type!r} is not ported; only endodav trains")
    num_ch = resnet_num_ch_enc(opt.num_layers)
    scales = tuple(opt.scales)
    return {
        "depth_model": EndoDAV(
            encoder=opt.encoder, r=opt.lora_rank, lora_type=opt.lora_type,
            image_shape=tuple(opt.depth_image_shape),
            residual_block_indexes=[] if opt.disable_residual_block else opt.residual_block_indexes,
            include_cls_token=opt.include_cls_token, inv_sigmoid=opt.inv_sigmoid,
            temporal_lora=opt.temporal_lora, conv_head=not opt.disable_conv_head,
            out_sigmoid=opt.out_sigmoid),
        "position_encoder": ResNetEncoder(opt.num_layers, num_input_images=2),
        "position": PositionDecoder(num_ch, scales),
        "transform_encoder": ResNetEncoder(opt.num_layers, num_input_images=2),
        "transform": TransformDecoder(num_ch, scales),
        "pose_encoder": ResNetEncoder(opt.num_layers, num_input_images=2),
        "pose": PoseDecoder(num_ch[-1], num_frames_to_predict_for=2),
        "intrinsics_head": IntrinsicsHead(256),
    }


@torch.no_grad()
def init_train_(mods: dict, seed: int) -> dict:
    """Seeded initialisation with the distributions of the JAX package's
    flax initialisers: lecun-normal weights, zero biases, unit norms,
    zero LoRA B, kaiming-uniform LoRA A, U/V uniform in [-1, 1], zero motion
    proj_out (an identity motion module), N(0, 1e-5) flow convs, LayerScale
    1e-5, cls/pos tokens N(0, 0.02)."""
    g = torch.Generator().manual_seed(seed)
    for comp in sorted(mods):
        for name, p in mods[comp].named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            noise = torch.randn(p.shape, generator=g)
            if leaf == "lora_A":
                value = (torch.rand(p.shape, generator=g) * 2 - 1) * p.shape[1] ** -0.5
            elif leaf in ("lora_U", "lora_V"):
                value = torch.rand(p.shape, generator=g) * 2 - 1
            elif leaf == "lora_B" or "proj_out" in name and "motion_modules" in name:
                value = torch.zeros(p.shape)
            elif leaf == "gamma":
                value = torch.full(p.shape, 1e-5)
            elif leaf in ("cls_token", "pos_embed", "mask_token"):
                value = 0.02 * noise
            elif "position_conv" in name and leaf == "weight":
                value = 1e-5 * noise
            elif p.ndim == 1:
                value = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
            else:
                value = noise * p[0].numel() ** -0.5
            p.copy_(value)
    return mods


def _flatten_bt(batch: dict) -> dict:
    """[B, T, ...] -> [B*T, ...] for the per-frame keys (trainer.py:163-179);
    the scale-0 stack and the jitter/window keys stay per item."""
    out = {}
    for k, v in batch.items():
        per_item = k == ("frames_scale0",) or k in _HOST_KEYS
        out[k] = v.reshape(-1, *v.shape[2:]) if not per_item and v.ndim >= 3 else v
    return out


class Trainer:
    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.device = resolve_device(opt) if device is None else device
        set_f32_policy()
        if opt.height % 32 or opt.width % 32:
            raise ValueError(f"--height/--width must be multiples of 32, got "
                             f"{opt.height}x{opt.width}")
        if tuple(opt.frame_ids) != FRAME_IDS:
            raise ValueError(f"the video trainer needs --frame_ids 0 -1 1, got {opt.frame_ids}")
        if opt.load_weights_folder:
            raise ValueError("--load_weights_folder: checkpoint loading is not ported yet")
        self.mods = init_train_(build_models(opt), opt.seed)
        if opt.pretrained_path:
            path = os.path.join(opt.pretrained_path, f"video_depth_anything_{opt.encoder}.pth")
            if os.path.exists(path):
                report = load_reference_pth(self.mods["depth_model"], path)
                print(f"[trainer] loaded {report['loaded']} tensors from {path}")
            else:
                print(f"[trainer] pretrained weights not found at {path}; training from init")
        for m in self.mods.values():
            m.to(self.device)
        self.main_mods = {k: self.mods[k] for k in MAIN_COMPONENTS}
        self.pos_mods = {k: self.mods[k] for k in POSITION_COMPONENTS}
        self.groups = O.assign_groups(self.main_mods)
        self.opt_main = O.GatedAdam(self.main_mods)
        self.opt_pos = O.GatedAdam(self.pos_mods)
        self.all_pos = {k: {n: 1.0 for n, _ in m.named_parameters()}
                        for k, m in self.pos_mods.items()}

        self.sched_cfg = {
            "lora_type": opt.lora_type, "warm_up_step": opt.warm_up_step,
            "tune_depth_interval": opt.tune_depth_interval, "temporal_lora": opt.temporal_lora,
            "tune_spatial_interval": opt.tune_spatial_interval,
            "tune_temporal_interval": opt.tune_temporal_interval,
            "train_output_conv": opt.train_output_conv,
            "legacy_frozen_groups": tuple(opt.legacy_frozen_groups or ()),
        }
        self.loss_cfg = {
            "scales": tuple(opt.scales), "height": opt.height, "width": opt.width,
            "T": max(opt.T, 1), "batch_size": opt.batch_size, "min_depth": opt.min_depth,
            "max_depth": opt.max_depth, "no_ssim": opt.no_ssim,
            "learn_intrinsics": opt.learn_intrinsics,
            "transform_constraint": opt.transform_constraint,
            "transform_smoothness": opt.transform_smoothness,
            "disparity_smoothness": opt.disparity_smoothness,
            "position_smoothness": opt.position_smoothness, "depth_reproj": opt.depth_reproj,
            "depth_flow": opt.depth_flow, "train": True,
        }
        self._setup_data()
        self.step = 1
        self.epoch = 0

    def _setup_data(self):
        opt = self.opt
        fpath = os.path.join(SPLITS_DIR, "scared_video", "train_files.txt")
        if not os.path.exists(fpath) or not os.path.isdir(opt.data_path):
            print("[trainer] split file or data_path missing; no data loader created")
            self.train_loader = self.train_dataset = None
            return
        self.train_dataset = ScaredVideoClips(
            opt.data_path, readlines(fpath), opt.height, opt.width, tuple(opt.frame_ids), 4,
            is_train=True, T=opt.T, frame_max_interval=opt.frame_max_interval)
        if len(self.train_dataset) < opt.batch_size:
            raise ValueError(
                f"video-clip train dataset has {len(self.train_dataset)} samples (< batch_size "
                f"{opt.batch_size}): the epoch would train nothing.  Check --T (the shipped "
                f"configs use --T 16; the default -1 yields no clips), --batch_size and the "
                f"sequence lengths under {opt.data_path}")
        self.train_loader = Loader(self.train_dataset, opt.batch_size, shuffle=True,
                                   num_workers=max(1, opt.num_workers))

    # ------------------------------------------------------------ step

    def device_batch(self, batch: dict) -> dict:
        """Loader batch [B, T, ...] -> the step's batch: float tensors on the
        card, the window map and jitter parameters on the host, and (for
        the device-preprocess layout) the pyramid and jitter built on the
        card and gathered into ("color"/"color_aug", frame, scale) keys."""
        out = {}
        for k, v in _flatten_bt(batch).items():
            if k == "depth_gt":  # never read by the losses
                continue
            if k in _HOST_KEYS:
                out[k] = np.asarray(v)
            else:
                out[k] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device,
                                                                       non_blocking=True)
        if ("frames_scale0",) in out:
            stacks = out.pop(("frames_scale0",))
            wmap = out.pop(("frame_window_map",))
            orders = out.pop(("jitter_order",))
            factors = torch.from_numpy(out.pop(("jitter_factors",)))
            scales = self.loss_cfg["scales"]
            pyr = [device_pyramid(stacks[b], len(scales), orders[b], factors[b])
                   for b in range(stacks.shape[0])]
            for si, s in enumerate(scales):
                for fi_i, fi in enumerate(FRAME_IDS):
                    for kind, j in (("color", 0), ("color_aug", 1)):
                        out[(kind, fi, s)] = torch.cat(
                            [pyr[b][j][si][torch.from_numpy(wmap[b, fi_i]).long().to(self.device)]
                             for b in range(len(pyr))])
        return out

    def current_lrs(self):
        decay = 0.1 ** (max(self.epoch - 1, 0) // self.opt.scheduler_step_size)
        return self.opt.learning_rate * decay, 1e-4 * decay

    def step_fn(self, batch: dict, lr: float, lr0: float) -> dict:
        """One training step on a device batch (trainer.py:354-474)."""
        cfg = self.loss_cfg
        scales, hw = cfg["scales"], (cfg["height"], cfg["width"])
        gates = O.schedule_gates(self.step, self.sched_cfg)

        # phase 0: the position nets (trainer.py:403-426)
        O.set_trainable(self.main_mods, None)
        O.set_trainable(self.pos_mods, self.all_pos)
        outputs = L.forward_flow_nets(self.mods, batch, scales, hw, train_position=True,
                                      train_transform=False)
        loss_0 = L.position_phase_loss(outputs, batch, scales, cfg["position_smoothness"],
                                       not cfg["no_ssim"])
        self.opt_pos.zero_grad()
        loss_0.backward()
        self.opt_pos.step(lr0)
        commit_batch_stats(self.mods["position_encoder"])
        del outputs

        # main phase (trainer.py:428-468)
        O.set_trainable(self.pos_mods, None)
        O.set_trainable(self.main_mods, O.gates_tree(self.groups, gates))
        loss, aux = L.main_phase(self.mods, batch, cfg, temporal_weight=gates["tune_temporal"])
        self.opt_main.zero_grad()
        loss.backward()
        self.opt_main.step(lr)
        for k in ("transform_encoder", "pose_encoder"):
            commit_batch_stats(self.mods[k])
        O.set_trainable(self.main_mods, None)

        scalars = {k: v.detach() for k, v in aux["losses"].items()}
        scalars["loss_0"] = loss_0.detach()
        return scalars

    def train_one_batch(self, batch: dict) -> dict:
        lr, lr0 = self.current_lrs()
        scalars = self.step_fn(self.device_batch(batch), lr, lr0)
        self.step += 1
        return scalars

    def run_epoch(self):
        for batch_idx, batch in enumerate(self.train_loader):
            t0 = time.time()
            scalars = self.train_one_batch(batch)
            if batch_idx % self.opt.log_frequency == 0:
                loss = float(scalars["loss"])  # waits for the step; the rate is honest
                eps = self.opt.batch_size / max(time.time() - t0, 1e-9)
                print(f"epoch {self.epoch:3d} | batch {batch_idx:6d} | examples/s {eps:6.1f} "
                      f"| loss {loss:.5f}")
