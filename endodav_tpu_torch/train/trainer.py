"""The self-supervised video trainer.

Port of `endodav_tpu/train/trainer.py`: `build_models` (the eight
components), a seeded initialisation, the two gated-Adam optimizers (main
lr ``--learning_rate``, position nets 1e-4, both x0.1 every
``--scheduler_step_size`` epochs), the schedule gates, `loss_cfg`, the
step (`step_fn`, trainer.py:354-474, run eagerly), `train_one_batch`
(with Dash's phase boundary, `_maybe_dash_phase_boundary`), `run_epoch`
(with the ``--random_train`` alternation, and every ``--log_frequency``
batches the scalars, the image panels and `val`), `val` (the NCC score of
one val batch), `train` (epochs, each followed by `run_epoch_eval`: video
depth with TAE/TAS and pose ATE/RE on the val sequences, appended to
``results.txt``; ``weights_{epoch}`` at a new best RMSE and
``weights_last`` every epoch), checkpoints in the JAX package's msgpack
layout (`utils/checkpoint.py`: either package loads what the other saved)
and ``--load_weights_folder`` with ``--models_to_load``.  The step runs
phase 0 (the position nets on `position_phase_loss`) and then the main
phase (depth, pose, transform and intrinsics nets on `main_phase`), each
with its own backward pass and Adam update, as the JAX step does inside
one jit.

Everything runs on the CUDA card unless ``--no_cuda`` asks for the CPU;
finding no card is an error.  Every ``--lora_type`` trains, with each
``--model_type`` as the depth model (JAX :83-113): EndoDAV, EndoDAC
(``--encoder`` vits or vitb; any other size builds vits) or AF-SfM, whose
depth parameters all fall in the ``frozen`` group, so that its step
trains the pose, transform, intrinsics and position nets only, as JAX's
does.  A single-frame depth model reads the ``endovis`` split for its
train and val clips (EndoDAV ``scared_video``); the epoch eval reads
``scared_video``'s val sequences for all three.  ``--compute_dtype
bfloat16`` builds every component with JAX's bf16 compute dtype (f32
parameters, Adam state and loss).  TensorBoard writers exist when
``tensorboardX`` imports, as in JAX.

``--mesh_shape data=N`` (JAX :209-221, :476-484) trains over the N ranks
of a `parallel.launch` world (N clamped to the world, as JAX clamps to
the visible chips): the [B, T, ...] batch is split on B (B % N raises),
each rank loading only its clips of the single process's batch; the
weights are broadcast from rank 0 and both optimizers' states stay
replicated; each rank backpropagates its share of the global loss (whose
batch reductions and BatchNorm statistics are the global batch's, see
`train/losses.py`) and the gradients are summed over the ranks, so a step
is the data=1 step.  ``val`` runs on each rank's slice with global
reductions and the epoch eval runs whole on every rank: one set of
numbers.  Rank 0 alone writes checkpoints, ``opt.json``, ``results.txt``
and TensorBoard; the other ranks wait at a barrier.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from endodav_tpu_torch.data.loader import Loader, readlines
from endodav_tpu_torch.data.pipeline import resize_frames
from endodav_tpu_torch.data.scared import ScaredVideoClips, ScaredVideos
from endodav_tpu_torch.eval import metrics as M
from endodav_tpu_torch.eval.engine import (METRIC_NAMES, evaluate_pose_pairs, resolve_device,
                                          sequence_pose_pairs, splits_dir)
from endodav_tpu_torch.eval.metrics_device import temporal_metrics_sequence
from endodav_tpu_torch.eval.video_inference import (DedupWindowForward, dedup_by_default,
                                                    infer_video_depth)
from endodav_tpu_torch.geometry.transforms import disp_to_depth
from endodav_tpu_torch.models.afsfm import AFSfMDepth
from endodav_tpu_torch.models.decoders import (DepthDecoder, IntrinsicsHead, PoseDecoder,
                                               PositionDecoder, TransformDecoder)
from endodav_tpu_torch.models.endodac import EndoDAC
from endodav_tpu_torch.models.endodav import EndoDAV
from endodav_tpu_torch.models.lora import LoRADense, dash_svd_update, set_dash_phase2
from endodav_tpu_torch.models.resnet import ResNetEncoder, commit_batch_stats, resnet_num_ch_enc
from endodav_tpu_torch.ops.jitter import device_pyramid
from endodav_tpu_torch.parallel import (barrier, build_mesh, data_parallel, data_sharding,
                                        is_main, loss_share, replicated, sum_gradients,
                                        world_devices)
from endodav_tpu_torch.train import losses as L
from endodav_tpu_torch.train import optim as O
from endodav_tpu_torch.utils import checkpoint as ckpt
from endodav_tpu_torch.utils.convert import jax_paths, load_reference_pth, to_jax_params
from endodav_tpu_torch.utils.precision import set_f32_policy

__all__ = ["Trainer", "build_models", "init_train_", "MAIN_COMPONENTS", "POSITION_COMPONENTS"]

MAIN_COMPONENTS = ("depth_model", "transform_encoder", "transform", "pose_encoder", "pose",
                   "intrinsics_head")
POSITION_COMPONENTS = ("position_encoder", "position")
FRAME_IDS = (0, -1, 1)
# keys of the device-preprocess batch that stay per item and on the host
_HOST_KEYS = (("frame_window_map",), ("jitter_order",), ("jitter_factors",))


def build_models(opt) -> dict:
    """The eight components of the video trainer (trainer.py:59-134), in
    the compute dtype of ``--compute_dtype`` (:80), and with
    ``--predictive_mask`` a ninth, the mask `DepthDecoder` (:125-134), which
    no loss reads, no optimizer steps and no checkpoint carries, as JAX's.
    The pose flags the video trainer cannot run raise JAX's errors (:60-79)."""
    if getattr(opt, "pose_model_type", "separate_resnet") != "separate_resnet":
        raise ValueError(
            f"pose_model_type={opt.pose_model_type!r} cannot run the video "
            "trainer (the reference crashes before the first step on these "
            "settings; see endodav_tpu/train/trainer.py:build_models). Use "
            "'separate_resnet'.")
    if getattr(opt, "pose_model_input", "pairs") != "pairs":
        raise ValueError(
            "pose_model_input='all' yields an empty predict_poses in the "
            "reference video trainer (trainer_end_to_end_video.py:745); use "
            "'pairs'.")
    dtype = torch.bfloat16 if opt.compute_dtype == "bfloat16" else torch.float32
    residual = [] if opt.disable_residual_block else opt.residual_block_indexes
    image_shape = tuple(opt.depth_image_shape)
    if opt.model_type == "endodav":
        depth = EndoDAV(
            encoder=opt.encoder, r=opt.lora_rank, lora_type=opt.lora_type,
            image_shape=image_shape, residual_block_indexes=residual,
            include_cls_token=opt.include_cls_token, inv_sigmoid=opt.inv_sigmoid,
            temporal_lora=opt.temporal_lora, conv_head=not opt.disable_conv_head,
            out_sigmoid=opt.out_sigmoid, dtype=dtype)
    elif opt.model_type == "afsfm":
        depth = AFSfMDepth(opt.num_layers, tuple(opt.scales), dtype=dtype)
    else:
        depth = EndoDAC(
            backbone_size=_endodac_size(opt), r=opt.lora_rank, lora_type=opt.lora_type,
            image_shape=image_shape, residual_block_indexes=residual,
            include_cls_token=opt.include_cls_token, pre_norm=opt.pre_norm,
            inv_sigmoid=opt.inv_sigmoid, conv_head=not opt.disable_conv_head, dtype=dtype)
    num_ch = resnet_num_ch_enc(opt.num_layers)
    scales = tuple(opt.scales)
    mods = {
        "depth_model": depth,
        "position_encoder": ResNetEncoder(opt.num_layers, num_input_images=2, dtype=dtype),
        "position": PositionDecoder(num_ch, scales, dtype=dtype),
        "transform_encoder": ResNetEncoder(opt.num_layers, num_input_images=2, dtype=dtype),
        "transform": TransformDecoder(num_ch, scales, dtype=dtype),
        "pose_encoder": ResNetEncoder(opt.num_layers, num_input_images=2, dtype=dtype),
        "pose": PoseDecoder(num_ch[-1], num_frames_to_predict_for=2, dtype=dtype),
        "intrinsics_head": IntrinsicsHead(256, dtype=dtype),
    }
    if getattr(opt, "predictive_mask", False):
        mods["predictive_mask"] = DepthDecoder(num_ch, scales,
                                               num_output_channels=len(opt.frame_ids) - 1,
                                               dtype=dtype)
    return mods


def _endodac_size(opt) -> str:
    """EndoDAC's backbone: vits or vitb, any other ``--encoder`` vits (JAX :105)."""
    return {"vits": "vits", "vitb": "vitb"}.get(opt.encoder, "vits")


def pretrained_file(opt) -> str | None:
    """The released initialisation of the depth model under
    ``--pretrained_path`` (JAX :281-298): ``video_depth_anything_<enc>.pth``
    for EndoDAV, ``depth_anything_v2_<vits|vitb>.pth`` for EndoDAC, none for
    AF-SfM."""
    if opt.model_type == "afsfm":
        return None
    name = (f"video_depth_anything_{opt.encoder}.pth" if opt.model_type == "endodav"
            else f"depth_anything_v2_{_endodac_size(opt)}.pth")
    return os.path.join(opt.pretrained_path, name)


@torch.no_grad()
def init_train_(mods: dict, seed: int) -> dict:
    """Seeded initialisation with the distributions of the JAX package's
    flax initialisers: lecun-normal weights, zero biases, unit norms,
    zero LoRA B, kaiming-uniform LoRA A, U/V uniform in [-1, 1], ssb's
    vectors at one, flora's A and B N(0, 0.02) and E zero, Dash's index and
    singular directions zero, zero motion proj_out (an identity motion
    module), N(0, 1e-5) flow convs, LayerScale 1e-5, cls/pos tokens
    N(0, 0.02)."""
    g = torch.Generator().manual_seed(seed)
    for comp in sorted(mods):
        variant_of = {n: m.variant for n, m in mods[comp].named_modules()
                      if isinstance(m, LoRADense)}
        for name, p in mods[comp].named_parameters():
            owner, _, leaf = name.rpartition(".")
            variant = variant_of.get(owner)
            noise = torch.randn(p.shape, generator=g)
            if variant == "ssb" and leaf in ("lora_A", "lora_B"):
                value = torch.ones(p.shape)
            elif variant == "flora" and leaf in ("lora_A", "lora_B"):
                value = 0.02 * noise
            elif leaf in ("lora_E", "lora_index", "weight_u_top", "weight_vt_top"):
                value = torch.zeros(p.shape)
            elif leaf == "lora_A":
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
        if os.environ.pop("ENDODAV_INT8", None):
            # serving-only flag (JAX trainer.py:184-189)
            print("[train] ENDODAV_INT8 is serving-only — ignored for training "
                  "(zero-gradient round() would freeze the trunk)")
        self.device = resolve_device(opt) if device is None else device
        set_f32_policy()
        if opt.height % 32 or opt.width % 32:
            raise ValueError(f"--height/--width must be multiples of 32, got "
                             f"{opt.height}x{opt.width}")
        if tuple(opt.frame_ids) != FRAME_IDS:
            raise ValueError(f"the video trainer needs --frame_ids 0 -1 1, got {opt.frame_ids}")
        self.log_path = os.path.join(opt.log_dir, opt.model_type)
        # the data mesh (JAX :209-211): the world's ranks, or this device alone
        self.mesh = build_mesh(getattr(opt, "mesh_shape", ""), clamp=True, devices=(
            world_devices() if dist.is_initialized() else [self.device]))
        data_sharding(opt.batch_size, self.mesh)  # B % N raises
        mods = build_models(opt)
        # the eight components' seeded init does not depend on the mask decoder
        self.mods = init_train_({k: m for k, m in mods.items() if k != "predictive_mask"},
                                opt.seed)
        if "predictive_mask" in mods:
            self.mods["predictive_mask"] = init_train_(
                {"predictive_mask": mods["predictive_mask"]}, opt.seed)["predictive_mask"]
        path = pretrained_file(opt) if opt.pretrained_path else None
        if path:
            if os.path.exists(path):
                report = load_reference_pth(self.mods["depth_model"], path)
                print(f"[trainer] loaded {report['loaded']} tensors from {path}")
            else:
                print(f"[trainer] pretrained weights not found at {path}; training from init")
        if opt.load_weights_folder:
            self.load_model()
        for m in self.mods.values():
            replicated(m.to(self.device), self.mesh)
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
        self.dash_phase2 = False
        self.dash_warmup = 100  # DashLinear's FLAG warm-up (mylora/layers.py:527)
        self.writers = {}  # TensorBoard writers, made by `train` (`_setup_logging`)
        self._last_images = None
        self._setup_data()
        self.step = 1
        self.epoch = 0

    def _maybe_dash_phase_boundary(self):
        """Dash's phase boundary (JAX trainer.py:253-277): once ``step``
        reaches ``dash_warmup``, SVD the frozen weights on the host
        (`dash_svd_update`) and switch the depth model to phase 2, in which
        ``lora_index`` trains."""
        if self.opt.lora_type != "dash" or self.dash_phase2 or self.step < self.dash_warmup:
            return
        print(f"[trainer] dash phase boundary at step {self.step}: running SVD update")
        dash_svd_update(self.mods["depth_model"])
        replicated(self.mods["depth_model"], self.mesh)  # one SVD's weights on every rank
        set_dash_phase2(self.mods["depth_model"], True)
        self.dash_phase2 = True

    def _setup_data(self):
        """The train and val clip loaders and the val sequences of the
        epoch eval (JAX :300-337), from the split directory as the
        environment names it now (`splits_dir`): the clips from
        ``scared_video`` for EndoDAV and ``endovis`` for a single-frame
        model, the sequences from ``scared_video`` for all."""
        opt = self.opt
        split = "scared_video" if opt.model_type == "endodav" else "endovis"
        fpath = os.path.join(splits_dir(), split, "{}_files.txt")
        if not os.path.exists(fpath.format("train")) or not os.path.isdir(opt.data_path):
            print("[trainer] split files or data_path missing; no data loaders created")
            self.train_loader = self.val_loader = self.val_iter = self.test_sequences = None
            self.train_dataset = None
            return
        self.train_dataset = ScaredVideoClips(
            opt.data_path, readlines(fpath.format("train")), opt.height, opt.width,
            tuple(opt.frame_ids), 4, is_train=True, T=opt.T,
            frame_max_interval=opt.frame_max_interval, device_preprocess=not opt.host_preprocess,
            random_capable=opt.random_train)
        if len(self.train_dataset) < opt.batch_size:
            raise ValueError(
                f"video-clip train dataset has {len(self.train_dataset)} "
                f"samples (< batch_size {opt.batch_size}) — the epoch "
                "would silently train nothing. Check --T (the shipped "
                "configs use --T 16; the default -1 yields no clips), "
                "--batch_size, and the sequence lengths under "
                f"{opt.data_path}")
        shard = (self.mesh.axis_rank("data"), self.mesh.axis_size("data"))
        self.train_loader = Loader(self.train_dataset, opt.batch_size, shuffle=True,
                                   num_workers=max(1, opt.num_workers), shard=shard)
        val_files = readlines(fpath.format("val"))
        val_dataset = ScaredVideoClips(opt.data_path, val_files, opt.height, opt.width,
                                       tuple(opt.frame_ids), 4, is_train=False, T=opt.T)
        self.val_loader = Loader(val_dataset, opt.batch_size, shuffle=False, shard=shard)
        self.val_iter = iter(self.val_loader)
        test_files = readlines(os.path.join(splits_dir(), "scared_video", "val_files.txt"))
        self.test_sequences = ScaredVideos(opt.data_path, test_files)
        self.num_total_steps = len(self.train_dataset) // opt.batch_size * opt.num_epochs

    def _setup_logging(self):
        """TensorBoard writers when tensorboardX imports (JAX :341-351), and
        ``models/opt.json``."""
        self.writers = {}
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print("[trainer] tensorboardX is not installed; TensorBoard logging is off")
        else:
            for mode in ("train", "val"):
                self.writers[mode] = SummaryWriter(os.path.join(self.log_path, mode))
        self.save_opts()

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

    def step_fn(self, batch: dict, lr: float, lr0: float) -> tuple[dict, dict]:
        """One training step on a device batch (trainer.py:354-474), over the
        data mesh; returns the loss scalars and the image panels
        (`_image_panels`)."""
        with data_parallel(self.mesh):
            return self._step(batch, lr, lr0)

    def _step(self, batch: dict, lr: float, lr0: float) -> tuple[dict, dict]:
        cfg = self.loss_cfg
        scales, hw = cfg["scales"], (cfg["height"], cfg["width"])
        gates = O.schedule_gates(self.step, self.sched_cfg, self.dash_phase2)

        # phase 0: the position nets (trainer.py:403-426)
        O.set_trainable(self.main_mods, None)
        O.set_trainable(self.pos_mods, self.all_pos)
        outputs = L.forward_flow_nets(self.mods, batch, scales, hw, train_position=True,
                                      train_transform=False)
        loss_0 = L.position_phase_loss(outputs, batch, scales, cfg["position_smoothness"],
                                       not cfg["no_ssim"])
        self.opt_pos.zero_grad()
        loss_share(loss_0).backward()
        sum_gradients([p for m in self.pos_mods.values() for p in m.parameters()], self.mesh)
        self.opt_pos.step(lr0)
        commit_batch_stats(self.mods["position_encoder"])
        del outputs

        # main phase (trainer.py:428-468)
        O.set_trainable(self.pos_mods, None)
        O.set_trainable(self.main_mods, O.gates_tree(self.groups, gates))
        loss, aux = L.main_phase(self.mods, batch, cfg, temporal_weight=gates["tune_temporal"])
        self.opt_main.zero_grad()
        loss_share(loss).backward()
        sum_gradients([p for m in self.main_mods.values() for p in m.parameters()], self.mesh)
        self.opt_main.step(lr)
        for k in ("transform_encoder", "pose_encoder"):
            commit_batch_stats(self.mods[k])
        O.set_trainable(self.main_mods, None)

        scalars = {k: v.detach() for k, v in aux["losses"].items()}
        scalars["loss_0"] = loss_0.detach()
        return scalars, _image_panels(aux["outputs"], scales)

    def train_one_batch(self, batch: dict) -> dict:
        self._maybe_dash_phase_boundary()
        lr, lr0 = self.current_lrs()
        scalars, self._last_images = self.step_fn(self.device_batch(batch), lr, lr0)
        self.step += 1
        return scalars

    # ----------------------------------------------------------- epochs

    def run_epoch(self):
        for batch_idx, batch in enumerate(self.train_loader):
            # the random_train alternation (JAX :505-524): independent frames
            # while the pose side trains; the dataset reads the flag when it
            # builds an item
            if self.opt.random_train and self.train_dataset is not None:
                tdi = self.opt.tune_depth_interval
                tune_depth = ((self.step % (2 * tdi)) >= tdi) if tdi > 0 else True
                self.train_dataset.random_train = not tune_depth
            t0 = time.time()
            scalars = self.train_one_batch(batch)
            if batch_idx % self.opt.log_frequency == 0:
                loss = float(scalars["loss"])  # waits for the step; the rate is honest
                eps = self.opt.batch_size / max(time.time() - t0, 1e-9)
                print(f"epoch {self.epoch:3d} | batch {batch_idx:6d} | examples/s {eps:6.1f} "
                      f"| loss {loss:.5f}")
                self.log_scalars("train", scalars)
                self.log_images("train", self._last_images)
                self.val()

    def val(self):
        """The NCC registration score of the next val batch (JAX :526-583),
        logged to the "val" writer: the flow nets alone, in eval mode with
        BatchNorm's running statistics, under no_grad; the modules' modes
        are put back after, and nothing a step reads changes."""
        if self.val_loader is None:
            return None
        try:
            batch = next(self.val_iter)
        except StopIteration:
            self.val_iter = iter(self.val_loader)
            batch = next(self.val_iter)
        batch = self.device_batch(batch)
        scales = self.loss_cfg["scales"]
        hw = (self.loss_cfg["height"], self.loss_cfg["width"])
        flow = [self.mods[k] for k in ("position_encoder", "position", "transform_encoder",
                                       "transform")]
        modes = [m.training for m in flow]
        for m in flow:
            m.eval()
        try:
            with torch.no_grad(), data_parallel(self.mesh):
                outputs = L.forward_flow_nets(self.mods, batch, scales, hw, train_position=False,
                                              train_transform=False)
                score = float(L.validation_ncc(outputs, batch, scales))
        finally:
            for m, mode in zip(flow, modes):
                m.train(mode)
        self.log_scalars("val", {"loss": score})
        w = self.writers.get("val")
        if w is not None:
            for f in (-1, 1):
                for tag in ("registration", "refined", "occu_mask_backward"):
                    img = outputs[(tag, 0, f)][0].float().cpu().numpy()
                    w.add_image(f"{tag}_{f}_0/0", np.moveaxis(img, -1, 0), self.step)
        return score

    def train(self):
        """``--num_epochs`` epochs, each followed by `run_epoch_eval`;
        ``weights_{epoch}`` at a new best RMSE, ``weights_last`` every epoch
        (JAX :585-594)."""
        if is_main():
            self._setup_logging()
        best_rmse = None
        for self.epoch in range(1, self.opt.num_epochs + 1):
            self.run_epoch()
            rmse, _ = self.run_epoch_eval()
            if is_main():
                if best_rmse is None or rmse < best_rmse:
                    best_rmse = rmse
                    self.save_model(mode="epoch")
                self.save_model(mode="last")
            barrier()

    def eval_forward(self):
        """The depth model's plain window forward (scale-0 disparity), with
        the dedup pipeline where `dedup_by_default` picks it: JAX's
        `run_epoch_eval` forward, not the serving engine's switches."""
        if not hasattr(self, "_eval_forward"):
            model = self.mods["depth_model"]

            def fwd(win: torch.Tensor) -> torch.Tensor:
                with torch.inference_mode():
                    return model(win)[("disp", 0)]

            fwd.dedup = DedupWindowForward(model) if dedup_by_default(model.image_shape) else None
            fwd.model = model
            self._eval_forward = fwd
        return self._eval_forward

    def run_epoch_eval(self):
        """Video depth (alignment, per-frame errors, TAE/TAS on the card)
        and pose (ATE/RE on pairs resized to the training size) over the
        val sequences (JAX :596-700); prints the means and the pose lines
        and appends them to ``models/results.txt``.  Returns (rmse, a1);
        ``eval_results`` keeps the means (`METRIC_NAMES`) and each sequence's
        `evaluate_pose_pairs` result."""
        if self.test_sequences is None:
            return float("inf"), 0.0
        opt = self.opt
        fwd = self.eval_forward()
        errors, errors_temp, pose_results = [], [], []
        for data in self.test_sequences:
            disp = infer_video_depth(fwd, data["colors"],
                                     image_shape=tuple(opt.depth_image_shape),
                                     chunk_windows=opt.chunk_windows, device=self.device,
                                     stitch="device" if opt.fast_stitch else "host",
                                     dedup=fwd.dedup)
            _, pred_depths = disp_to_depth(disp, opt.min_depth, opt.max_depth)
            pred_depths = np.asarray(pred_depths)
            if opt.depth_align == "scale":
                pred_depths, _ = M.median_scaling(data["depths"], pred_depths)
            else:
                pred_depths, *_ = M.align_shift_and_scale(data["depths"], pred_depths)
            masks, clipped, i2ls = [], [], []
            for pred, gt, pose, K in zip(pred_depths, data["depths"], data["poses"],
                                         data["Ks"]):
                mask = (gt > 1e-3) & (gt < 150.0)
                pred = np.clip(pred * opt.pred_depth_scale_factor, 1e-3, 150.0)
                e = M.compute_errors(gt, pred, mask)
                if not np.isnan(e).all():
                    errors.append(e)
                masks.append(mask)
                clipped.append(pred)
                i2ls.append(np.linalg.inv(K @ pose))
            tae, tas = temporal_metrics_sequence(np.stack(clipped), np.stack(masks),
                                                 np.stack(i2ls), device=self.device)
            errors_temp.append([tae * 100.0, tas])

            gt_local, pairs = sequence_pose_pairs(data)
            pairs = resize_frames(pairs, (opt.height, opt.width))
            pm = (self.mods["pose_encoder"], self.mods["pose"], self.mods["intrinsics_head"])
            res = evaluate_pose_pairs(opt, gt_local, pairs, pose_modules=pm,
                                      device=self.device)
            pose_results.append(res)
        mean_errors = np.array(errors).mean(0)
        mean_temp = np.array(errors_temp).mean(0) if errors_temp else np.zeros(2)
        vals = list(mean_errors) + list(mean_temp)
        pose_lines = [f"{name}: ATE {r['ate_mean']:.4f}±{r['ate_std']:.4f} | "
                      f"RE {r['re_mean']:.4f}±{r['re_std']:.4f}"
                      for name, r in zip(self.test_sequences.filenames, pose_results)]
        print("eval:", " | ".join(f"{n}={v:.4f}" for n, v in zip(METRIC_NAMES, vals)))
        for line in pose_lines:
            print("  " + line)
        w = next(iter(self.writers.values()), None)
        if w is not None:
            for n, v in zip(METRIC_NAMES, vals):
                w.add_scalar(f"de/{n}", float(v), self.epoch)
        results = os.path.join(self.log_path, "models", "results.txt")
        if is_main():
            os.makedirs(os.path.dirname(results), exist_ok=True)
            with open(results, "a") as f:
                f.write(f"Epoch {self.epoch:02d}: " + " ".join(f"{v:.4f}" for v in vals) + "\n")
                for line in pose_lines:
                    f.write("  " + line + "\n")
        self.eval_results = {"values": vals, "pose": pose_results}
        return float(mean_errors[2]), float(mean_errors[4])

    # ------------------------------------------------------------- misc

    def log_scalars(self, mode: str, scalars: dict):
        w = self.writers.get(mode)
        if w is None:
            return
        for k, v in scalars.items():
            w.add_scalar(k, float(v), self.step)

    def log_images(self, mode: str, images: dict | None):
        """TensorBoard image panels (JAX :719-729): up to 4 samples a tag,
        disparities min-max normalised."""
        w = self.writers.get(mode)
        if w is None or not images:
            return
        for tag, t in images.items():
            arr = t.float().cpu().numpy()
            if tag.startswith("disp"):
                lo = arr.min(axis=(1, 2, 3), keepdims=True)
                hi = arr.max(axis=(1, 2, 3), keepdims=True)
                arr = (arr - lo) / np.maximum(hi - lo, 1e-5)
            for j in range(arr.shape[0]):
                w.add_image(f"{tag}/{j}", np.moveaxis(arr[j], -1, 0), self.step)

    def save_opts(self):
        models_dir = os.path.join(self.log_path, "models")
        os.makedirs(models_dir, exist_ok=True)
        with open(os.path.join(models_dir, "opt.json"), "w") as f:
            json.dump({k: v for k, v in vars(self.opt).items() if not k.startswith("_")}, f,
                      indent=2, default=str)

    def adam_state(self) -> dict:
        """Both optimizers' state as JAX's ``{"main", "position"}`` trees of
        ``{mu, nu, count}`` over each component's params (mu and nu in
        flax's layouts; zeros and a count of 0 where a parameter never had
        a gradient)."""
        def tree(gadam, mods):
            out = {"mu": {}, "nu": {}, "count": {}}
            for comp, module in mods.items():
                kind = ckpt.component_kind(comp, module)
                params = dict(module.named_parameters())
                states = {n: gadam.state_of(p) for n, p in params.items()}
                for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                    out[key][comp] = to_jax_params(
                        {n: st.get(torch_key, torch.zeros_like(params[n]))
                         for n, st in states.items()}, kind)["params"]
                paths = jax_paths(kind)
                out["count"][comp] = _nest(
                    {paths[n][1][1:]: np.asarray(float(st.get("step", 0)), np.float32)
                     for n, st in states.items()})
            return out

        return {"main": tree(self.opt_main, self.main_mods),
                "position": tree(self.opt_pos, self.pos_mods)}

    def save_model(self, mode: str = "epoch"):
        """``weights_{epoch}`` or ``weights_last`` under ``models/`` (JAX
        :731-745): the eight components, the depth model's metadata, and
        ``adam.msgpack``."""
        folder = os.path.join(self.log_path, "models",
                              f"weights_{self.epoch}" if mode == "epoch" else "weights_last")
        ckpt.save_components(folder, {**self.main_mods, **self.pos_mods}, metadata={
            "height": self.opt.height, "width": self.opt.width,
            "use_stereo": self.opt.use_stereo, "dash_phase2": bool(self.dash_phase2)})
        ckpt.save_pytree(os.path.join(folder, "adam.msgpack"), self.adam_state())
        return folder

    def load_model(self):
        """``--models_to_load`` from ``--load_weights_folder`` (JAX
        :747-751); Adam starts fresh."""
        folder = os.path.expanduser(self.opt.load_weights_folder)
        if not os.path.isdir(folder):
            raise FileNotFoundError(f"Cannot find folder {folder}")
        names = self.opt.models_to_load
        unknown = [n for n in names if n not in self.mods]
        if unknown:
            raise ValueError(f"--models_to_load names unknown components {unknown}")
        loaded = ckpt.load_components(folder, self.mods, names)
        print(f"loaded {loaded} from {folder}; Adam is freshly initialized")


def _nest(flat: dict) -> dict:
    """{path tuple: leaf} -> nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return out


def _image_panels(outputs: dict, scales) -> dict:
    """The step's TensorBoard panels (JAX :440-456): brightness,
    registration, refined, warped colour and occlusion at scale 0 and the
    disparity pyramid, the first 4 samples of each, detached copies."""
    keys = {}
    for f in (-1, 1):
        keys.update({f"brightness_{f}_0": ("transform", "high", 0, f),
                     f"registration_{f}_0": ("registration", 0, f),
                     f"refined_{f}_0": ("refined", 0, f), f"color_{f}_0": ("color", f, 0),
                     f"occu_mask_backward_{f}_0": ("occu_mask_backward", 0, f)})
    for s in scales:
        keys[f"disp_{s}"] = ("disp", s)
    return {tag: outputs[k][:4].detach().clone() for tag, k in keys.items() if k in outputs}
