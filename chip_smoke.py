#!/usr/bin/env python3
"""Drive the PyTorch port's serving, streaming and training paths on one CUDA card.

    python3 chip_smoke.py [--profile-step TRACE_DIR] [--profile-serving TRACE_DIR]

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from `endodav_tpu_torch/csrc/` with nvcc, and
     beside them the tile's error check (`endodav_tpu_torch/bench/`);
  3. the f32 error of the 3xTF32 tensor-core tile (`csrc/tc_tile.cuh`)
     against a float64 product as K grows, held to half the f32 tolerance;
     each kernel against its plain PyTorch version on the card, at the
     shapes of the serving path and of the training step: flash attention
     (f32, bf16, and its gradient; f32 also against float64; also at
     EndoDAC's 8-frame batches, vits and vitb's 12 heads), the fused
     temporal block at every motion-module width (vits C=64, 192, 384;
     vitl C=256 and 1024) in f32 and bf16, the fused MLP at vits and vitl
     widths and at EndoDAC's 8-frame batches (vits; vitb on a cluster of
     3), the fused RCU at the vits head's shapes and EndoDAC's (C=64 and
     128) (these four on the
     tensor cores, f32 as 3xTF32: both bounds, the rate reached, and the
     temporal block's two launches), the temporal attention at
     the training step's and a 518x644 window's shapes, vitl's head
     widths 32 and 128 among them (and its gradient), the int8 serving
     GEMM (`int8_dense`); the grid-sample forward and both backward
     kernels at the four warp calls of the training step (and the share
     of the fused backward's tiles whose d_img box fits shared memory,
     the kernel's count held to the plain box rule), the fused backward
     on displacements that force its global-atomics branch in half its
     tiles, their channel-plane twins at the C > 1 calls
     (also against the interleaved kernels), and the forward splat (also
     timed on flow-shaped coordinates whose neighbours scatter); with
     the kernel's, the plain version's and one PyTorch call's times (the
     splat's two: index_put_ and index_add_).  The
     plain versions and the PyTorch calls of these phases run in IEEE f32
     (TF32 off) inside a local context (`ieee_f32`); the later phases run
     under the precision policy that the entry points set themselves
     (`endodav_tpu_torch/utils/precision.py`): PyTorch's default switches
     (cuDNN TF32 on) are put back before each entry point is called, and
     the policy it left is checked after;
  4. the full-width vits EndoDAV (random weights from a seed) on one
     8-frame 224x280 clip, as built and with ENDODAV_FUSED_RCU=1, a vits
     RoPE EndoDAV on the same clip, and the full-width merged vitl on one
     4-frame 112x140 clip, on the card with the kernels (int8 off) against
     the CPU with the plain versions; then the vits model in bf16
     (`EndoDAV.clone(dtype=torch.bfloat16)`) on a 4-frame clip as built,
     with ENDODAV_FUSED_RCU=1, merged with ENDODAV_FUSED_MLP=1, and with
     RoPE, each launching its kernel at bf16, held against the CPU's f32
     relative to the CPU bf16 plain version's own error (`BF16_REL_MAX`);
     the single-frame models (EndoDAC vits and vitb with plain LoRA, vitb
     merged with ENDODAV_FUSED_MLP=1 and ENDODAV_FUSED_RCU=1, vits with
     BatchNorm RCUs, AF-SfM) against the CPU the same way; the JAX
     engine's A/B switches (ENDODAV_NO_FLASH, ENDODAV_LOWRES_OUTCONV,
     ENDODAV_NO_FUSED, ENDODAV_FUSED_TRAIN, ENDODAV_NO_WARP_MM), each with
     its launches; `cli/test_simple`'s disparity against the CPU; the LoRA
     family (vits EndoDAV with ssb and --temporal_lora, with Dash in phase
     1 and in phase 2, with galora and with flora; EndoDAC with ssb; the
     shipped eval's ssb model in bf16) the same way;
  5. the serving path as the CLI runs it (engine.build_depth_model ->
     depth_window_forward -> evaluate_video_sequences) over synthetic
     SCARED-like 64-frame sequences: vitl 518x644 merged (dedup in taps
     mode, int8 GEMMs, device stitch), the vits 518x644 headline (dedup in
     prefix mode) as built, with ENDODAV_FUSED_MLP=1 and with
     ENDODAV_FUSED_RCU=1, and the 224x280 CLI default (window path), and
     the single-frame branch in batches of 8 (EndoDAC vitb as built and
     merged with both opt-in kernels, vits, AF-SfM at 256x320, each also
     timed warm); finite metrics and the launches of every serving kernel
     per encode batch, window chunk or frame batch checked; the shipped
     eval's configuration (vits ssb at 518x644, no residual blocks, no conv
     head, dedup) as built, merged, and merged with ENDODAV_FUSED_MLP=1,
     then as built and merged warm in turns: ms/frame of each and their
     largest |Δdisp| within MODEL_TOL; then `cli/evaluate_depth` on a
     synthetic SCARED `endovis` tree;
  6. live streaming (`eval/streaming.py:DepthStreamer`) with
     ENDODAV_FUSED_RCU=1 over one 64-frame sequence pushed frame by frame:
     vits 518x644 merged on dedup (prefix mode) and the 224x280 default on
     the window path; the output against the offline path on the card,
     the buffer bound, the launches per push and per fired window, the
     median ms per push and per fired window;
  6b. the TPU benchmark's serving (`bench.py:96-132`) in bf16 beside f32:
     the vits 518x644 headline (merged, dedup, `transfer_dtype=np.float16`,
     device stitch) and vitl 518x644 (merged, int8, dedup), ms per source
     frame of each over the 64-frame sequence, the bf16 launches checked,
     the headline's bf16 disparity against f32 relative to the CPU plain
     bf16 version's own error; and the baseline leg (`sequential=True`,
     one window a chunk, f32 transfer, host stitch) in f32 against a
     batched run of the same 54 frames to MODEL_TOL;
  7. one small training step (64x96 frames, T=4, ViT input 56x70) on the
     card with the kernels against the same step on the CPU with the
     plain versions, with and without ENDODAV_WARP_CP=1: both phase
     losses, the gradients and the updated values of a LoRA B and a
     pose-decoder weight;
  8. the training step at full width at `scripts/train_video.sh`'s
     configuration (vits, 256x320, batch 1, T=16) with dvlora in place of
     its ssb and --warm_up_step 2 (the one check of DV-LoRA's warm-up
     switch from A/B to U/V): `Trainer` built through the option parser on a
     synthetic SCARED tree written from the seed, 4 steps of
     `train_one_batch` and 2 more with ENDODAV_WARP_CP=1, with finite
     losses, the expected parameter changes and the expected launches of
     every kernel per step, and the share of the depth warps' tiles that
     summed d_img in shared memory (the kernel's count), and the splat
     kernel against its plain version and timed on the step's own
     coordinates; ms/step and the peak memory; a small-configuration pair
     of Dash steps across the phase boundary, card against CPU (phase 2
     trains lora_index, leaves the singular directions); and 2 steps of
     `scripts/train_video.sh` exactly (ssb): launches, the ssb vectors
     trained, ms/step and peak memory; then both commands of
     `scripts/train_video.sh` through the CLIs (`run_training_script`) on
     a synthetic tree with ground truth in a split directory of its own:
     one epoch of 7 steps with `val` every 2 batches, the epoch eval
     (depth, TAE/TAS on the card, pose) and the checkpoints in the JAX
     package's msgpack layout, every step's losses finite and every
     kernel's launches checked; a fresh `Trainer` loading ``weights_last``
     bit for bit; `cli/evaluate_depth_video_pose` on it with finite
     metrics and its launches; the batched TAE/TAS on the card against the
     CPU; ms/step, val, eval, checkpoint and CLI seconds and peak memory;
     then the other depth models on the tree through an ``endovis`` split
     of its sequences (`run_single_frame_training`): `train_video_dac.sh`'s
     ``--T -1`` raising JAX's error, its EndoDAC vitb dvlora model and
     AF-SfM for 2 steps each in f32 and in bf16 (launches checked, LoRA B
     moved, AF-SfM's depth weights and statistics unmoved); the ssb
     training in bf16 beside f32 on the same weights and batches
     (`run_bf16_training`: step 1's losses with the warp kernels within
     2e-3 of the plain versions', the attention kernels on bf16 tensors,
     ms/step and peak of each, the bf16-to-f32 gap reported), a small
     bf16 step on the card against the CPU; and both commands
     of `scripts/train_video_dac1.sh` (`run_dac1_script`: one epoch of 4
     steps of 16 frames with `val`, the epoch eval on the window path, the
     LoRA A/B stepped, ``weights_last`` reloaded bit for bit, the script's
     own eval flags refusing it as JAX's do, the pose eval CLI with
     ``--disable_conv_head``); the kernel phases add flash attention at the
     training batches (B=16 and B=8 at 12 heads) with both gradients in
     f32 and bf16, temporal attention's bf16 gradient at the three
     training shapes, and the warps and splat fed bf16 through
     `ops/sampling.py` against the plain versions.  The depth model
     trains as JAX's `_apply` calls it, with ``train=False`` where it has
     no BatchNorm statistics, so an APE EndoDAV step launches the fused
     temporal block 8 times (rows 2/3; checked at the training shapes,
     T=16) and no temporal attention; a RoPE EndoDAV's ssb steps in f32
     and bf16 (`run_rope_training`) keep row 4's unfused route;
  8b. the scripts a user runs after `scripts/train_video.sh`, on the
     ``weights_last`` it saved: `scripts/eval_depth_video1.sh`
     (`cli/evaluate_depth_video_hamlyn` with ``--visualize_depth`` on a
     synthetic Hamlyn tree of 2 x 64 288x360 frames: the launches of rows
     1 and 2/3 per window chunk, finite metrics, each sequence's vis.mp4
     or JAX's "mp4 export failed" line and its 64 depth .npy files), then
     `scripts/eval_depth_video_hamlyn_npy.sh` (``--pred_root`` on those
     files: no launch, the metrics within HAMLYN_RESCORE_RTOL of the model
     run's) and ``--max_length 32``; `scripts/export_gt.sh` and
     `scripts/eval_pose.sh` (`cli/export_gt --what both`,
     `cli/evaluate_pose`) in the training tree's split directory, and
     `cli/visualize` (``--mode pose`` on the npz files it wrote, drawn
     where matplotlib imports, its trajectory points checked in any case;
     ``--mode reconstruction`` on the Hamlyn run's depth files), each
     phase's seconds and ms/frame or ms/pair;
  9. a JSON line per kernel (rows 1-6 with their bf16 launches and bf16
     error against the plain version; rows 1 and 4 also their launches in
     bf16 training and their rows at the training shapes) and, last, the
     device line.

``--profile-step TRACE_DIR`` adds a `torch.profiler` run of one more
full-width step, ``--profile-serving TRACE_DIR`` one each of vitl, the
vits headline, EndoDAC vitb and vits and AF-SfM serving over a 64-frame
sequence (`profile_serving`, also callable alone): device time by kernel
name, the device's idle share, and the Chrome traces in TRACE_DIR.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

SEED = 0
# f32: summation order of the kernels' products and the online-softmax
# rescaling differ from the plain version's; bf16: the kernels' inputs and
# the rounded intermediates (y and the attention output) carry 8 bits of
# mantissa, compared with the plain version in f32 on the same inputs.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MODEL_TOL = 2e-4  # whole model, card (kernels, the entry points' f32 policy) vs CPU (plain)
# bf16 disparity: the bounds of tests/test_torch_bf16_serving.py, set at
# JAX's init weights (disparity in 0.29-0.83), where JAX's own bf16 error
# is 1.0e-2 max, 1.9e-3 mean.  At the engine's seed weights the disparity
# spans 0.0003-0.9999 and JAX's own bf16 error against its f32 reaches
# 4.2e-2 max, 3.8e-3 mean at scale 0 of the 518x644 headline, 5.9e-2 and
# 7.1e-3 over the scales of the 224x280 CLI default
# (tools/bf16_reference_error.py), so there the card is held, like that
# test's second bound, to the bf16 plain version's own error against f32
# on the same weights and frames: the mean within 1.5x, the largest within
# 2x (a maximum over one clip varies more)
BF16_MAX, BF16_MEAN = 2.5e-2, 4e-3
BF16_REL_MAX, BF16_REL_MEAN = 2.0, 1.5
# flash attention (B, N): 224x280 window chunks (2 x 32 frames); 518x644
# window chunks and dedup encode batches of 32 frames at vits (H=6) and
# vitl (H=16); EndoDAC's single-frame batches of 8 224x280 frames at vits
# and vitb (H=12), which are also train_video_dac.sh's vitb training
# batches; the training step's 16 frames (EndoDAV B*T, train_video_dac1.sh's
# EndoDAC batch); the vitg trunk's VITG_FRAMES 518x644 frames (H=24)
VITG_FRAMES = 4
FLASH_SHAPES = [(64, 321, 6), (64, 1703, 6), (32, 1703, 16), (8, 321, 6), (8, 321, 12),
                (16, 321, 6), (VITG_FRAMES, 1703, 24)]
# the gradient of the kernel path at the training batches: (B, N, H)
FLASH_GRAD_SHAPES = [(16, 321, 6), (8, 321, 12)]
# temporal block (C, rows) of one 518x644 window: vits's four motion
# modules; vitl's C=1024 ones and its C=256 ones
TEMPORAL_SHAPES = [(192, 1702), (384, 437), (64, 6808), (1024, 1702), (1024, 437), (256, 1702),
                   (256, 6808)]
# the training step's motion modules (T=16; the shapes of TATTN_SHAPES'
# first four), which take the block since the depth model trains with
# train=False
TEMPORAL_TRAIN_SHAPES = [(192, 320), (384, 80), (64, 320), (64, 1280)]
# fused MLP (C, H, rows): a dedup encode batch of 32 518x644 frames; an
# EndoDAC batch of 8 224x280 frames at vits and at vitb (768 columns: the
# widest tile on a cluster of 3); the vitg trunk's frames (1536 columns: 64-row
# tiles on a cluster of 6), and 2048 columns on the largest cluster, 8 (no
# model has that width: the kernel's widest)
MLP_SHAPES = [(384, 1536, 32 * 1703), (1024, 4096, 32 * 1703), (384, 1536, 8 * 321),
              (768, 3072, 8 * 321), (1536, 6144, VITG_FRAMES * 1703), (2048, 8192, 4096)]
# fused RCU (B, H, W, C): the vits head's RCU inputs of one 518x644 window
# (refinenet4 19x23, refinenet3 37x46, refinenet2 74x92, refinenet1
# 148x184) and of a 224x280 window (refinenet1 64x80); EndoDAC's of a batch
# of 8 224x280 frames (refinenet4 8x10 .. refinenet1 64x80) at vits (C=64)
# and vitb (C=128)
ENDODAC_RCU_HW = [(8, 10), (16, 20), (32, 40), (64, 80)]
RCU_SHAPES = ([(32, 19, 23, 64), (32, 37, 46, 64), (32, 74, 92, 64), (32, 148, 184, 64),
               (32, 64, 80, 64)] + [(8, h, w, c) for c in (64, 128) for h, w in ENDODAC_RCU_HW])
# temporal attention (rows, T, Dh) over 8 heads: the training step's motion
# modules (256x320 frames, ViT input 224x280, T=16: C=192, 384, 64 at
# 16x20, 8x10 and 16x20, 32x40 pixels) and a 518x644 serving window's
# (T=32, 37x46, 19x23, 74x92 pixels), and vitl's RoPE modules' head widths
# (C=256 at 37x46, C=1024 at 19x23)
TATTN_SHAPES = [(320, 16, 24), (80, 16, 48), (320, 16, 8), (1280, 16, 8), (1702, 32, 24),
                (437, 32, 48), (6808, 32, 8), (1702, 32, 32), (437, 32, 128)]
# the tile's error against K: the contraction widths of the kernels' f32
# products (the temporal block's C = 64 .. 1024, the MLP's fc1 at 384 and
# 1024 and fc2 at 1536 and 4096), on TILE_ROWS x TILE_COLS outputs
TILE_KS = [64, 192, 384, 1024, 1536, 4096]
TILE_ROWS, TILE_COLS = 4096, 256
# the serving configurations of the main path: the 518x644 headline, and
# vitl at it as the CLI serves it (dedup in taps mode, int8 by default)
HEADLINE = ["--depth_image_shape", "518", "644", "--merge_lora", "--disable_residual_block"]
VITL_ARGS = ["--encoder", "vitl", *HEADLINE, "--chunk_windows", "1", "--fast_stitch"]
# the shipped eval's model flags (scripts/train_video.sh:23,
# scripts/eval_depth_video1.sh:12: ssb, no residual blocks, no conv head)
# at the headline's 518x644, the CLI's defaults otherwise
SSB = ["--lora_type", "ssb"]
SHIPPED_EVAL = [*SSB, "--disable_residual_block", "--disable_conv_head",
                "--depth_image_shape", "518", "644"]
# the single-frame models at the CLI's 224x280: EndoDAC vits and vitb with
# plain LoRA (the reference's EndoDAC), and AF-SfM (ResNet-18)
ENDODAC = ["--model_type", "endodac", "--lora_type", "lora"]
ENDODAC_VITB = [*ENDODAC, "--encoder", "vitb"]
AFSFM = ["--model_type", "afsfm"]
# warps: outputs and coordinate gradients to 1e-5 of max(1, their largest
# entry) (one thread computes what the plain version computes, up to FMA
# contraction); d_img and the splat map are summed with atomics in an order
# that changes from run to run: relative 1e-4
WARP_TOL, ATOMIC_RTOL = 1e-5, 1e-4
# small training step, card (kernels, TF32 off) vs CPU (plain versions):
# losses relative 1e-4; gradients 1e-3 of their largest entry; the updated
# values to 1e-7 where the gradient is above 1e-3 of its largest entry
# (Adam's first step is lr * g / (|g| + eps): a gradient near 0 may take
# either sign on the two devices)
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_UPDATE_ATOL = 1e-4, 1e-3, 1e-7
# one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s; dense FLOP/s of f32
# outside the tensor cores (TF32 is off) and of bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# f32 products on the tensor cores as 3xTF32 (the fused MLP, the temporal
# block): three TF32 passes at the 495 TFLOP/s TF32 rate
TF32X3_FLOPS = 495e12 / 3
TRAIN_HW, TRAIN_T, SPLIT = (256, 320), 16, "splits/scared_video/train_files.txt"
VAL_SPLIT = "splits/scared_video/val_files.txt"
# scripts/train_video.sh with the trainer's default --lora_type dvlora and
# --warm_up_step 2, so that steps 1-2 train the LoRA A/B and steps 3-4 the
# dvlora vectors
TRAIN_FLAGS = ["--model_type", "endodav", "--encoder", "vits", "--batch_size", "1",
               "--disable_residual_block", "--disable_conv_head", "--depth_reproj", "1e-2",
               "--temporal_lora", "--tune_spatial_interval", "400",
               "--tune_temporal_interval", "100", "--lora_type", "dvlora", "--warm_up_step", "2",
               "--num_workers", "2", "--seed", str(SEED)]
# scripts/train_video.sh:11-17 and :19-22, the training and the eval command's
# flags exactly (ssb; steps 1-399 train the spatial scale vectors)
SCRIPT_TRAIN_FLAGS = ["--model_type", "endodav", "--num_workers", "4", "--batch_size", "1",
                      "--T", str(TRAIN_T), "--encoder", "vits", "--disable_residual_block",
                      "--disable_conv_head", *SSB, "--warm_up_step", "200000",
                      "--depth_reproj", "1e-2", "--temporal_lora",
                      "--tune_spatial_interval", "400", "--tune_temporal_interval", "100"]
SCRIPT_EVAL_FLAGS = ["--model_type", "endodav", "--eval_split", "scared_video", "--eval_mono",
                     "--disable_residual_block", "--disable_conv_head", *SSB]
SSB_TRAIN_FLAGS = [*SCRIPT_TRAIN_FLAGS, "--seed", str(SEED)]
SSB_STEPS = 2
# launches per training step of each kernel, from train/losses.py:
# grid-sample forward: phase 0 registration, main phase registration +
#   colour synthesis + depth warps = 4 (no loss reads the flow-consistency
#   map, so the step does not compute it; check_warps still checks that
#   warp's kernel at its shape);
# coordinate-only backward: phase-0 registration (the position nets train)
#   + main-phase colour synthesis = 2 (the main phase's registration warp
#   sees frozen position nets, so it has no backward);
# fused backward: the main-phase depth warps = 1; splat: one occlusion map
#   per phase = 2 (its mask is a constant to the loss: no backward);
# flash attention: the 12 ViT blocks of the one depth forward = 12 (the
#   backward is a plain recompute); temporal block: the 4 motion modules x
#   2 attention sub-blocks of that forward = 8 (the depth model is called
#   with train=False, as JAX's `_apply` calls it: APE takes the fused
#   block, whose backward is a plain recompute); temporal attention: 0
#   (RoPE's route, ROPE_STEP_LAUNCHES);
# channel planes: none without ENDODAV_WARP_CP
STEP_LAUNCHES = {"grid_sample_fwd": 4, "grid_sample_bwd_coord": 2, "grid_sample_bwd_fused": 1,
                 "grid_sample_fwd_cp": 0, "grid_sample_bwd_coord_cp": 0,
                 "grid_sample_bwd_fused_cp": 0, "splat": 2, "flash_attention": 12,
                 "fused_temporal_block": 8, "temporal_attention": 0}
# a RoPE EndoDAV's step: its motion modules take the unfused route, two
# temporal attentions a module
ROPE_STEP_LAUNCHES = dict(STEP_LAUNCHES, fused_temporal_block=0, temporal_attention=8)
ROPE_STEPS = 2
# with ENDODAV_WARP_CP=1 the C=3 warps take planes: the forward of both
# registration warps and of colour synthesis (3), the coordinate backward
# of phase 0's registration and of colour synthesis (2); the depth warps
# are C=1 and stay interleaved (forward 1, fused backward 1)
STEP_LAUNCHES_CP = dict(STEP_LAUNCHES, grid_sample_fwd=1, grid_sample_fwd_cp=3,
                        grid_sample_bwd_coord=0, grid_sample_bwd_coord_cp=2)
CP_STEPS = 2  # full-width steps with ENDODAV_WARP_CP=1 after the default ones


class SmokeFailure(RuntimeError):
    pass


@contextlib.contextmanager
def _env(env):
    """Set the environment variables ``env`` for the block, then restore."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def ieee_f32():
    """PyTorch's f32 convolutions (cuDNN) and products in IEEE f32, TF32
    off, for the block: the kernel phases' plain versions and library
    yardsticks are defined so; the switches are restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def own_policy(where: str, entry_point, *args, **kwargs):
    """Call an entry point that sets the f32 policy itself, from PyTorch's
    default switches (cuDNN convolutions in TF32, products in IEEE f32),
    and require that it left TF32 off; returns what it returned.  The
    switches are put back first so that an earlier phase's policy cannot
    stand in for this entry point's."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    out = entry_point(*args, **kwargs)
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            f"{where}: TF32 is on after the entry point set its f32 policy")
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def time_calls(fns: dict, iters: int = 5) -> dict:
    """Mean ms per call of each function (CUDA events), run in turns in the
    given order and then reversed (plain, kernel, kernel, plain) after two
    warm-up calls each."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for fn in list(fns.values()) * 2:
        fn()
    torch.cuda.synchronize()
    order = list(fns) + list(reversed(fns))
    times = {name: 0.0 for name in fns}
    for name in order:
        times[name] += run(fns[name]) / 2
    return times


def time_pair(kernel, plain, iters: int = 5) -> tuple[float, float]:
    t = time_calls({"plain": plain, "kernel": kernel}, iters)
    return t["kernel"], t["plain"]


def bound(nbytes: float, flops: float, dtype=torch.float32,
          tf32x3: bool = False) -> tuple[float, str]:
    """Least ms the card could take: the larger of the bytes over HBM rate
    and the operations over the peak rate of their type; with ``tf32x3``,
    f32 operations at the 3xTF32 rate (3x the operations at the TF32
    tensor-core peak) instead of the SIMT f32 rate."""
    rate = TF32X3_FLOPS if tf32x3 and dtype == torch.float32 else PEAK_FLOPS[dtype]
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_core_bounds(row, nbytes, flops, dtype):
    """A tensor-core kernel's row: its bound (3xTF32 for f32, bf16 on the
    tensor cores), the f32 SIMT bound beside it, the design, and the rate
    reached (TFLOP/s of the function's own operations)."""
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype, tf32x3=True)
    if dtype == torch.float32:
        row["bound_simt_ms"] = bound(nbytes, flops, dtype)[0]
    row["design"] = ("tensor cores, 3xTF32 mma.sync" if dtype == torch.float32
                     else "tensor cores, bf16 mma.sync")
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12


def device_ms_by_kernel(fn, iters: int = 3) -> dict | None:
    """Mean device ms a call of each kernel that ``fn`` launches, from
    torch.profiler (None where the profiler shows no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0}
    return found or None


def attention64(qkv, heads):
    """Attention of a packed [B, N, 3C] qkv in float64, [B, N, C]."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (qkv.double()[..., i * c:(i + 1) * c].reshape(b, n, heads, -1) for i in range(3))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * (c // heads) ** -0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c)


def check_flash(device, shapes=FLASH_SHAPES, dh=64, timing=True):
    from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED)
    for b, n, heads in shapes:
        c = heads * dh
        qkv = torch.randn((b, n, 3 * c), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            xf = x.float()
            want = attention_reference(*(xf[..., i * c:(i + 1) * c].reshape(b, n, heads, dh)
                                         for i in range(3)), dh ** -0.5).reshape(b, n, c)
            got = qkv_attention(x, heads).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            row = dict(shape=f"B={b} N={n} H={heads} Dh={dh}", dtype=str(dtype)[6:], err=err)
            if timing:
                split = lambda: [x[..., i * c:(i + 1) * c].reshape(b, n, heads, dh)  # noqa: E731
                                 for i in range(3)]
                # the library yardstick: SDPA on [B, H, N, Dh] copies made here
                qh, kh, vh = (t.transpose(1, 2).contiguous() for t in split())
                t = time_calls({
                    "plain": lambda: attention_reference(*split(), dh ** -0.5),
                    "kernel": lambda: qkv_attention(x, heads),
                    "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, scale=dh ** -0.5)})
                row["ms"], row["plain_ms"], row["library_ms"] = t["kernel"], t["plain"], t["library"]
                # read qkv once, write the output once; QK^T and PV
                tensor_core_bounds(row, x.element_size() * b * n * 4 * c,
                                   4.0 * b * heads * n * n * dh, dtype)
            if dtype == torch.float32:
                # against float64: the tensor-core partials' accumulation order
                row["err_f64"] = max(
                    (got[i:i + 8].double() - attention64(qkv[i:i + 8], heads)).abs().max().item()
                    for i in range(0, b, 8))
            print(f"[flash_attention] {row}")
            require(err <= TOL[dtype], f"flash_attention {row}: max |err| above {TOL[dtype]}")
            rows.append(row)
    return rows


def check_flash_grad(device, shapes=FLASH_GRAD_SHAPES, dh=64):
    """The kernel path's d_qkv (CUDA forward, recompute backward) against
    the plain version's autograd on the same inputs (in f32 for bf16 ones),
    at the training batches' ViT shapes, f32 and bf16.  Returns the largest
    error at each dtype."""
    from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    for b, n, heads in shapes:
        c = heads * dh
        qkv = torch.randn((b, n, 3 * c), generator=g, device=device)
        cot = torch.randn((b, n, c), generator=g, device=device)
        for dtype in errs:
            x = qkv.to(dtype).requires_grad_()
            out = qkv_attention(x, heads)
            require(out.grad_fn is not None, "qkv_attention returned a result without grad_fn")
            (got,) = torch.autograd.grad(out, x, cot.to(dtype))
            require(got.dtype == dtype, f"flash_attention gradient in {got.dtype}, not {dtype}")
            xr = qkv.to(dtype).float().requires_grad_()
            ref = attention_reference(*(xr[..., i * c:(i + 1) * c].reshape(b, n, heads, dh)
                                        for i in range(3)), dh ** -0.5).reshape(b, n, c)
            (want,) = torch.autograd.grad(ref, xr, cot.to(dtype).float())
            err = (got.float() - want).abs().max().item()
            scale = want.abs().max().item()
            print(f"[flash_attention grad] B={b} N={n} H={heads} {str(dtype)[6:]}: max |err| "
                  f"{err:.3e} (largest entry {scale:.3e})")
            require(err <= TOL[dtype] * max(1.0, scale),
                    f"flash_attention gradient B={b} H={heads} {dtype}: max |err| {err}")
            errs[dtype] = max(errs[dtype], err)
    return errs


def unfused_block(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads):
    """The library yardstick of the temporal block: the sub-block in
    PyTorch's own calls (layer_norm, linear, scaled_dot_product_attention)."""
    import torch.nn.functional as F

    b, t, c = x.shape
    y = (F.layer_norm(x.float(), (c,), gamma, beta, 1e-5) + pe).to(x.dtype)
    q, k, v = (F.linear(y, w.t()).reshape(b, t, heads, c // heads).transpose(1, 2)
               for w in (wq, wk, wv))
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, c)
    return x + F.linear(o, wo.t(), bo)


def check_temporal(device, shapes=TEMPORAL_SHAPES, t=32, heads=8, timing=True):
    """The temporal block's two tensor-core launches at every motion-module
    width against their plain version, in f32 and bf16: the kernels sum
    the heads in order in one f32 accumulator and add x and bo before
    rounding, `grouped_reference_block`'s order (one head group below 512
    channels)."""
    from endodav_tpu_torch.kernels.fused_temporal_block import (GROUPED_MIN_C,
                                                                 fused_temporal_block,
                                                                 grouped_reference_block,
                                                                 tile_config)
    from endodav_tpu_torch.models.motion import sinusoidal_time_encoding

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    for c, nrows in shapes:
        f = lambda *s, sd=1.0: torch.randn(s, generator=g, device=device) * sd  # noqa: E731
        # |out| stays below 4, where bf16 output rounding is at most 2^-7
        x = f(nrows, t, c, sd=0.5)
        gamma, beta = 1.0 + f(c, sd=0.1), f(c, sd=0.1)
        pe = torch.from_numpy(sinusoidal_time_encoding(32, c)[:t]).to(device)
        ws = [f(c, c, sd=c ** -0.5) for _ in range(4)]
        bo = f(c, sd=0.1)
        for dtype in (torch.float32, torch.bfloat16):
            args = [a.to(dtype) for a in (x, *ws, bo)]
            xd, wq, wk, wv, wo, bod = args
            ref_args = [a.float() for a in args]
            want = grouped_reference_block(ref_args[0], gamma, beta, pe, *ref_args[1:5],
                                           ref_args[5], heads)
            got = fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            tol = TOL[dtype]
            bn, hs = tile_config(c, heads, dtype)
            # rows 2 (C < 512) and 3 (C >= 512) of the TPU kernels' table
            row = dict(shape=f"rows={nrows} T={t} C={c}", dtype=str(dtype)[6:], err=err,
                       margin=err / tol, kernel="grouped" if c >= GROUPED_MIN_C else "block",
                       tiles=f"bn={bn} hs={hs}")
            if timing:
                t_ = time_calls({
                    "plain": lambda: grouped_reference_block(xd, gamma, beta, pe, wq, wk, wv, wo,
                                                             bod, heads),
                    "kernel": lambda: fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo,
                                                           bod, heads),
                    "library": lambda: unfused_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod,
                                                     heads)})
                row["ms"], row["plain_ms"], row["library_ms"] = (t_["kernel"], t_["plain"],
                                                                 t_["library"])
                # x read and the output written once, the weights once; four
                # C x C products per token and the T x T attention per row
                nbytes = (xd.element_size() * (2 * nrows * t * c + 4 * c * c + c)
                          + 4 * (2 * c + t * c))
                flops = 2.0 * nrows * t * 4 * c * c + 4.0 * nrows * t * t * c
                tensor_core_bounds(row, nbytes, flops, dtype)
                # the two launches: the q|k|v projection, and the attention
                # with the out-projection
                split = device_ms_by_kernel(lambda: fused_temporal_block(
                    xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads))
                if split:
                    row["launch_ms"] = {next((n for n in ("qkv_kernel", "out_kernel")
                                              if n in k), k[:60]): v
                                        for k, v in split.items()}
            print(f"[fused_temporal_block] {row}")
            require(err <= tol, f"fused_temporal_block {row}: max |err| above {tol}")
            rows.append(row)
    return rows


def check_tile_error(device, ks=TILE_KS, m=TILE_ROWS, n=TILE_COLS):
    """The f32 error of the 3xTF32 tile in the kernels' accumulation order
    (`bench/tile_error.py:tile_matmul`) against a float64 product of the
    same f32 operands, as K grows, beside one f32 product's: a ~ N(0, 1)
    and b ~ N(0, 1/K) as the kernels' operands, and their absolute values,
    where every cut toward zero has one sign.  The error is max |err| /
    max(1, max |ref|) and must stay within half the f32 tolerance."""
    from endodav_tpu_torch.bench.tile_error import tile_matmul

    g = torch.Generator(device=device).manual_seed(SEED + 10)
    rows = []
    for k in ks:
        a0 = torch.randn((m, k), generator=g, device=device)
        b0 = torch.randn((k, n), generator=g, device=device) * k ** -0.5
        for dist, (a, b) in (("signed", (a0, b0)), ("positive", (a0.abs(), b0.abs()))):
            ref = a.double() @ b.double()
            scale = max(1.0, ref.abs().max().item())
            row = dict(k=k, dist=dist, rows=m, cols=n)
            row["tile"] = (tile_matmul(a, b).double() - ref).abs().max().item() / scale
            row["f32_product"] = (a @ b - ref).abs().max().item() / scale
            print(f"[tile error] {row}")
            require(row["tile"] <= TOL[torch.float32] / 2,
                    f"tile: error {row['tile']} above half the f32 tolerance")
            rows.append(row)
    return rows


def check_fused_mlp(device, shapes=MLP_SHAPES, timing=True):
    """The fused MLP against its plain version at vits and vitl widths, f32
    and bf16, to TOL of max(1, the largest entry); the library yardstick is
    F.linear + F.gelu + F.linear on torch-layout copies of the weights."""
    import torch.nn.functional as F

    from endodav_tpu_torch.kernels.fused_mlp import fused_mlp, mlp_reference

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    for c, h, nrows in shapes:
        x = torch.randn((nrows, c), generator=g, device=device)
        w1 = torch.randn((c, h), generator=g, device=device) * c ** -0.5
        w2 = torch.randn((h, c), generator=g, device=device) * h ** -0.5
        b1 = torch.randn(h, generator=g, device=device) * 0.1
        b2 = torch.randn(c, generator=g, device=device) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            xd, w1d, w2d = x.to(dtype), w1.to(dtype), w2.to(dtype)
            want = mlp_reference(xd, w1d, b1, w2d, b2).float()
            got = fused_mlp(xd, w1d, b1, w2d, b2).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            tol = TOL[dtype] * max(1.0, want.abs().max().item())
            row = dict(shape=f"rows={nrows} {c}->{h}->{c}", dtype=str(dtype)[6:], err=err,
                       margin=err / tol)
            if timing:
                w1t, w2t = w1d.t().contiguous(), w2d.t().contiguous()
                b1d, b2d = b1.to(dtype), b2.to(dtype)
                t_ = time_calls({
                    "plain": lambda: mlp_reference(xd, w1d, b1, w2d, b2),
                    "kernel": lambda: fused_mlp(xd, w1d, b1, w2d, b2),
                    "library": lambda: F.linear(F.gelu(F.linear(xd, w1t, b1d)), w2t, b2d)})
                row["ms"], row["plain_ms"], row["library_ms"] = (t_["kernel"], t_["plain"],
                                                                 t_["library"])
                # x read and the output written once, the weights and biases
                # once; two products
                tensor_core_bounds(row, xd.element_size() * (2 * nrows * c + 2 * c * h)
                                   + 4 * (h + c), 4.0 * nrows * c * h, dtype)
            print(f"[fused_mlp] {row}")
            require(err <= tol, f"fused_mlp {row}: max |err| above {tol}")
            rows.append(row)
    return rows


def check_int8(device, rows=32 * 1703, c=1024):
    """`int8_dense` at vitl's qkv projection of a 518x644 encode batch: the
    card's int8 product (torch._int_mm) equals the plain int64 product of
    the same int8 operands, and the whole function its plain version with
    that product; the deviation from f32 and the times are reported."""
    import torch.nn.functional as F

    from endodav_tpu_torch.ops.quant import int8_dense, int_matmul, quantize_rows, quantize_weight

    g = torch.Generator(device=device).manual_seed(SEED + 6)
    x = torch.randn((rows, c), generator=g, device=device)
    w = torch.randn((3 * c, c), generator=g, device=device) * c ** -0.5
    b = torch.randn(3 * c, generator=g, device=device) * 0.1
    x8, xs = quantize_rows(x)
    w8, ws = quantize_weight(w)
    acc = int_matmul(x8, w8)
    acc_plain = int_matmul(x8.cpu(), w8.cpu())
    torch.cuda.synchronize(device)
    acc_err = (acc.cpu().long() - acc_plain).abs().max().item()
    want = acc_plain.to(device).float() * xs * ws + b
    got = int8_dense(x, w, b)
    err = (got - want).abs().max().item()
    t_ = time_calls({"plain": lambda: F.linear(x, w, b), "kernel": lambda: int8_dense(x, w, b)})
    row = dict(shape=f"[{rows},{c}] x [{3 * c},{c}]^T", acc_err=acc_err, err=err,
               dev_from_f32=(got - F.linear(x, w, b)).abs().max().item(), ms=t_["kernel"],
               f32_linear_ms=t_["plain"])
    print(f"[int8_dense] {row}")
    require(acc_err == 0, f"int8 product differs from the exact one by {acc_err}")
    require(err <= 1e-6 * max(1.0, want.abs().max().item()), f"int8_dense {row}")
    return row


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _coords(g, n, h, w, device, align_corners=True):
    """Fractional pixel coordinates [n, h, w] of a smooth displacement
    field plus noise, reaching a few pixels past every border."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    ph = torch.rand((n, 1, 1), generator=g, device=device) * 6.283
    fx = xx + 6 * torch.sin(ph + yy / 17) + 1.5 * torch.randn((n, h, w), generator=g, device=device)
    fy = yy + 6 * torch.cos(ph + xx / 23) + 1.5 * torch.randn((n, h, w), generator=g, device=device)
    return fx.contiguous(), fy.contiguous()


def _library_inputs(img, fx, fy, tile, align, zeros):
    """The library yardstick's inputs for a warp call: NCHW copies of the
    images expanded over img_tile, the normalised grid and the padding."""
    h, w = img.shape[1:3]
    inp = img.permute(0, 3, 1, 2).repeat_interleave(tile, 0).contiguous()
    if align:
        grid = torch.stack([fx / (w - 1) * 2 - 1, fy / (h - 1) * 2 - 1], -1)
    else:
        grid = torch.stack([(2 * fx + 1) / w - 1, (2 * fy + 1) / h - 1], -1)
    return inp, grid, "zeros" if zeros else "border"


# the warp calls of the training step at 256x320, batch 1, T=16, four
# scales: (name, images, channels, img_tile, zeros mode, align_corners,
# image gradient); the registration warp repeats colour synthesis's call
# with flow-shaped coordinates; the flow-consistency warp is JAX's fourth
# warp call, whose map no loss reads (the port's step leaves it out)
WARP_CALLS = [("colour synthesis", 32, 3, 4, False, True, False),
              ("registration flow_warp", 32, 3, 4, False, True, False),
              ("flow_consistency", 128, 2, 1, False, False, True),
              ("depth warps", 240, 1, 1, True, True, True)]


def kernel_fit_share(fused, row) -> float:
    """The share of the last fused-backward launch's tiles that summed d_img
    in shared memory, from the kernel's own count of the others; required to
    be the plain box rule's share (``row["fit_share"]``)."""
    glob, tiles = fused.global_blocks(), fused.last_tiles
    share = 1 - glob / tiles
    require(glob == round((1 - row["fit_share"]) * tiles),
            f"{row.get('call', 'fused backward')}: {glob} of {tiles} tiles took global atomics, "
            f"the box rule gives a fit share of {row['fit_share']}")
    return share


def check_warps(device, hw=TRAIN_HW):
    """Each warp kernel against its plain version at the training step's
    shapes: the forward, every gradient, the times of the kernel, the plain
    version and one PyTorch call (F.grid_sample forward, aten's
    grid_sampler_2d_backward), the bound, and the share of the fused
    backward's tiles whose d_img box fits shared memory."""
    import torch.nn.functional as F

    from endodav_tpu_torch.kernels import warp_matmul as W

    h, w = hw
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = []
    for name, b_img, c, tile, zeros, align, img_grad in WARP_CALLS:
        bg = b_img * tile
        img = torch.rand((b_img, h, w, c), generator=g, device=device)
        fx, fy = _coords(g, bg, h, w, device)
        cot = torch.randn((bg, h, w, c), generator=g, device=device)

        def grads(fn):
            i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
            out = fn(i if img_grad else i.detach(), x, y)
            wrt = [x, y] + ([i] if img_grad else [])
            return (out.detach(), *torch.autograd.grad(out, wrt, cot))

        got = grads(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile))
        want = grads(lambda i, x, y: W.grid_sample_reference(i, x, y, zeros, tile))
        torch.cuda.synchronize(device)
        errs = [(a - b).abs().max().item() for a, b in zip(got[:3], want[:3])]
        scales = [max(1.0, b.abs().max().item()) for b in want[:3]]
        row = dict(call=name, shape=f"img [{b_img},{h},{w},{c}] coords [{bg},{h},{w}]",
                   img_tile=tile, zeros=zeros, align_corners=align, err_out=errs[0],
                   err_dfx=errs[1], err_dfy=errs[2])
        for e, sc, what in zip(errs, scales, ("output", "d_fx", "d_fy")):
            require(e <= WARP_TOL * sc, f"{name}: {what} max |err| {e} above {WARP_TOL * sc}")
        # the share of the fused backward's tiles whose d_img box fits shared
        # memory, by the plain box rule (and, fused, by the kernel's count)
        row["fit_share"] = W.tile_fit_share(fx, fy, h, w, c)
        if img_grad:
            row["err_dimg"] = (got[3] - want[3]).abs().max().item()
            row["rel_dimg"] = _rel_err(got[3], want[3])
            require(row["rel_dimg"] <= ATOMIC_RTOL,
                    f"{name}: d_img relative err {row['rel_dimg']} above {ATOMIC_RTOL}")
            row["kernel_fit_share"] = kernel_fit_share(W.grid_sample_bwd_fused_cuda, row)

        # times: the kernels alone, the plain forward, the plain backward
        # from a kept graph, and the library calls on NCHW copies with a
        # normalised grid made here (its images expanded over img_tile)
        inp, grid, pad = _library_inputs(img, fx, fy, tile, align, zeros)
        i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
        plain_out = W.grid_sample_reference(i if img_grad else i.detach(), x, y, zeros, tile)
        wrt = [x, y] + ([i] if img_grad else [])
        cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
        mask = [img_grad, True]
        fwd = time_calls({
            "plain": lambda: W.grid_sample_reference(img, fx, fy, zeros, tile),
            "kernel": lambda: W.grid_sample_fwd_cuda(img, fx, fy, zeros, tile),
            "library": lambda: F.grid_sample(inp, grid, "bilinear", pad, align)})
        bwd_kernel = ((lambda: W.grid_sample_bwd_fused_cuda(img, fx, fy, cot, zeros)) if img_grad
                      else (lambda: W.grid_sample_bwd_coord_cuda(img, fx, fy, cot, zeros, tile)))
        # the fused kernel's parts: the coordinate-only kernel on the same
        # inputs, and the zeroed d_img the wrapper allocates
        parts = ({"coord": lambda: W.grid_sample_bwd_coord_cuda(img, fx, fy, cot, zeros),
                  "zeros": lambda: torch.zeros_like(img)} if img_grad else {})
        bwd = time_calls({
            "plain": lambda: torch.autograd.grad(plain_out, wrt, cot, retain_graph=True),
            "kernel": bwd_kernel,
            "library": lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_nchw, inp, grid, 0, 0 if zeros else 1, align, mask), **parts})
        p, img_b, c4 = bg * h * w, b_img * h * w * c * 4, c * 4
        # forward: image, coordinates and output once; a few flops a sample
        row["fwd"] = dict(ms=fwd["kernel"], plain_ms=fwd["plain"], library_ms=fwd["library"])
        row["fwd"]["bound_ms"], row["fwd"]["bound_by"] = bound(img_b + p * (8 + c4),
                                                               p * (16 + 8 * c))
        # backward: image, coordinates and cotangent read once, the two
        # coordinate gradients (and d_img) written once
        row["bwd"] = dict(ms=bwd["kernel"], plain_ms=bwd["plain"], library_ms=bwd["library"],
                          **{f"{k}_ms": bwd[k] for k in parts})
        row["bwd"]["bound_ms"], row["bwd"]["bound_by"] = bound(
            img_b * (2 if img_grad else 1) + p * (16 + c4), p * (16 + 16 * c))
        print(f"[warp] {row}")
        rows.append(row)
        del plain_out, wrt
    return rows


BF16_WARP_TOL = 2 ** -7  # two bf16 ulps of the largest entry


def check_warps_bf16(device, hw=TRAIN_HW):
    """The warps and the splat as the bf16 training step feeds them, through
    `ops/sampling.py`, whose wrapper casts to f32 for the f32 kernels and
    back as JAX's does, against the same calls on the plain versions
    (ENDODAV_NO_WARP_MM=1): the registration warp (bf16 flows on f32
    frames, img_tile 4), the depth warps (bf16 depths on an f32 grid, both
    gradients) and the occlusion splat (bf16 flows).  Outputs and
    gradients in JAX's dtypes, within two bf16 ulps of the largest entry
    (WARP_TOL for the f32 registration output).  Returns the largest error
    relative to max(1, the largest entry)."""
    from endodav_tpu_torch.ops import sampling as S

    h, w = hw
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")

    def flows(n):  # smooth (dy, dx) flows of a few pixels, bf16
        ph = torch.rand((n, 1, 1), generator=g, device=device) * 6.283
        return torch.stack([3 * torch.sin(ph + xx / 23), 3 * torch.cos(ph + yy / 17)],
                           -1).to(torch.bfloat16)

    frames = torch.rand((32, h, w, 3), generator=g, device=device)
    depth = (1 + 99 * torch.rand((240, h, w, 1), generator=g, device=device)).to(torch.bfloat16)
    fx, fy = _coords(g, 240, h, w, device)
    grid = torch.stack([fx / (w - 1) * 2 - 1, fy / (h - 1) * 2 - 1], -1)
    calls = {
        "registration": (lambda f: S.flow_warp(frames, f, img_grad=False, img_tile=4),
                         [flows(128)]),
        "depth warps": (lambda d, gr: S.grid_sample(d, gr, padding_mode="zeros",
                                                    align_corners=True), [depth, grid]),
        "occlusion splat": (lambda f: S.occlusion_mask_backward(f)[1], [flows(128)]),
    }
    rows = []
    for name, (fn, leaves) in calls.items():
        outs = {}
        for route, env in (("kernel", {}), ("plain", {"ENDODAV_NO_WARP_MM": "1"})):
            with _env(env):
                ins = [t.clone().requires_grad_(name != "occlusion splat") for t in leaves]
                out = fn(*ins)
                if name == "occlusion splat":
                    outs[route] = [out]
                    continue
                cot = (torch.randn(out.shape, generator=g, device=device).to(out.dtype)
                       if route == "kernel" else outs["kernel"][-1])
                outs[route] = [out.detach(), *torch.autograd.grad(out, ins, cot), cot]
        got, want = outs["kernel"][:len(leaves) + 1], outs["plain"][:len(leaves) + 1]
        dtypes = [str(t.dtype)[6:] for t in got]
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        scales = [max(1.0, b.float().abs().max().item()) for b in want]
        row = dict(call=name, dtypes=dtypes, err=errs,
                   rel=[e / sc for e, sc in zip(errs, scales)])
        print(f"[warp bf16] {row}")
        require(dtypes == [str(t.dtype)[6:] for t in want], f"warp bf16 {name}: dtypes differ")
        for i, (e, sc) in enumerate(zip(errs, scales)):
            tol = WARP_TOL if got[i].dtype == torch.float32 and i == 0 else BF16_WARP_TOL
            require(e <= tol * sc, f"warp bf16 {name}: entry {i} max |err| {e} above {tol * sc}")
        rows.append(row)
    require([r["dtypes"] for r in rows] == [["float32", "bfloat16"],
                                            ["bfloat16", "bfloat16", "float32"], ["bfloat16"]],
            f"warp bf16: output and gradient dtypes {[r['dtypes'] for r in rows]}")
    return max(max(r["rel"]) for r in rows)


def check_warp_branches(device, n=16, hw=TRAIN_HW):
    """The fused backward (depth warps: C=1, zeros mode) on coordinates
    displaced by up to +-40 px in the left half of the grid, whose tiles'
    d_img boxes exceed the shared-memory budget and take global atomics, and
    by a few pixels in the right half, whose boxes fit: both branches run,
    the kernel's count matches the plain box rule, and the result matches
    the plain version and the plain tiled decomposition
    (`bwd_tiled_reference`); the kernel's, the plain backward's and aten's
    times and the bound."""
    from endodav_tpu_torch.kernels import warp_matmul as W

    h, w = hw
    g = torch.Generator(device=device).manual_seed(SEED + 10)
    img = torch.rand((n, h, w, 1), generator=g, device=device)
    fx, fy = _coords(g, n, h, w, device)
    wild = (torch.arange(w, device=device) < w // 2).float()
    fx = (fx + wild * (80 * torch.rand((n, h, w), generator=g, device=device) - 40)).contiguous()
    fy = (fy + wild * (80 * torch.rand((n, h, w), generator=g, device=device) - 40)).contiguous()
    cot = torch.randn((n, h, w, 1), generator=g, device=device)
    got = W.grid_sample_bwd_fused_cuda(img, fx, fy, cot, True)
    row = dict(shape=f"img [{n},{h},{w},1] coords [{n},{h},{w}], +-40 px in the left half",
               fit_share=W.tile_fit_share(fx, fy, h, w, 1))
    row["kernel_fit_share"] = kernel_fit_share(W.grid_sample_bwd_fused_cuda, row)
    require(0 < row["kernel_fit_share"] < 1,
            f"forced branches: fit share {row['kernel_fit_share']}, expected both branches")
    i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
    plain_out = W.grid_sample_reference(i, x, y, True)
    plain = torch.autograd.grad(plain_out, (i, x, y), cot, retain_graph=True)
    tiled = W.bwd_tiled_reference(img, fx, fy, cot, True)
    require(abs(tiled[3] - row["fit_share"]) < 1e-6, f"tiled reference share {tiled[3]}")
    for label, want in (("plain", plain), ("tiled", tiled)):
        row[f"rel_dimg_vs_{label}"] = _rel_err(got[0], want[0])
        require(row[f"rel_dimg_vs_{label}"] <= ATOMIC_RTOL, f"forced branches: {row}")
        for k, what in ((1, "dfx"), (2, "dfy")):
            row[f"err_{what}_vs_{label}"] = e = (got[k] - want[k]).abs().max().item()
            require(e <= WARP_TOL * max(1.0, want[k].abs().max().item()), f"forced: {row}")
    inp, grid, pad = _library_inputs(img, fx, fy, 1, True, True)
    cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
    t = time_calls({"plain": lambda: torch.autograd.grad(plain_out, (i, x, y), cot,
                                                         retain_graph=True),
                    "kernel": lambda: W.grid_sample_bwd_fused_cuda(img, fx, fy, cot, True),
                    "library": lambda: torch.ops.aten.grid_sampler_2d_backward(
                        cot_nchw, inp, grid, 0, 0, True, [True, True])})
    row.update(ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"])
    # as check_warps's fused backward at C=1: image, coordinates and
    # cotangent read once, d_img and the coordinate gradients written once
    p = n * h * w
    row["bound_ms"], row["bound_by"] = bound(2 * 4 * p + p * (16 + 4), p * (16 + 16))
    print(f"[warp branches] {row}")
    return row


def _splat_coords(g, n, h, w, device):
    """Pixel grids shifted by a whole-pixel offset in [-20, 20] and a
    fraction in [0.15, 0.85] per image and axis: interior occupancy is 1
    and the border strips take values in [0.02, 0.85], so no pixel sits
    within rounding of the 0.95 threshold."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    shift = (torch.randint(-20, 21, (n, 2, 1, 1), generator=g, device=device).float()
             + 0.15 + 0.7 * torch.rand((n, 2, 1, 1), generator=g, device=device))
    return ((xx + shift[:, 0]).reshape(n, -1).contiguous(),
            (yy + shift[:, 1]).reshape(n, -1).contiguous())


def splat_library_calls(x, y, h, w):
    """The splat's library yardsticks on coordinates [B, P]: one
    index_put_(accumulate=True) (PyTorch's sorting path) and one index_add_
    (the atomic scatter the plain version uses) of the four corners'
    indices and masses into a zeroed map."""
    n = x.shape[0]
    x1, y1 = torch.floor(x), torch.floor(y)
    idx, vals = [], []
    base = (torch.arange(n, device=x.device) * (h * w))[:, None]
    for cx, cy in ((x1 + 1, y1 + 1), (x1 + 1, y1), (x1, y1 + 1), (x1, y1)):
        ok = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        val = (1 - (x - cx).abs()) * (1 - (y - cy).abs()) * ok
        idx.append((base + (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()).reshape(-1))
        vals.append(val.reshape(-1))
    idx, vals = torch.cat(idx), torch.cat(vals)
    acc = torch.zeros(n * h * w, device=x.device)
    return {"index_put_": lambda: acc.index_put_((idx,), vals, accumulate=True),
            "index_add_": lambda: acc.index_add_(0, idx, vals)}


def splat_agreement(x, y, h, w):
    """The splat kernel's map against the plain version's on the same
    coordinates [B, P]: the relative error, the pixels whose `occ > 0.95`
    mask flips, the plain map's pixels within the kernel's largest error of
    0.95 (where the atomics' summation order alone can flip it), and the
    ms per call on them of the kernel (the map's zeroing included), the
    plain version and the two library calls."""
    from endodav_tpu_torch.kernels import warp_matmul as W

    got, want = W.splat_cuda(x, y, h, w), W.splat_reference(x, y, h, w)
    err = (got - want).abs().max()
    t = time_calls({"plain": lambda: W.splat_reference(x, y, h, w),
                    "kernel": lambda: W.splat_cuda(x, y, h, w),
                    **splat_library_calls(x, y, h, w)})
    return dict(rel_occ=_rel_err(got, want), flips=int(((got > 0.95) != (want > 0.95)).sum()),
                near=int(((want - 0.95).abs() <= err).sum()), ms=t["kernel"],
                plain_ms=t["plain"], index_put_ms=t["index_put_"], index_add_ms=t["index_add_"])


def check_splat(device, n=128, hw=TRAIN_HW):
    """The splat kernel against its plain version at the training step's
    occlusion-map shape: the map, its gradient, the 0.95 mask flips, the
    times and the bound; the library yardsticks
    are one index_put_(accumulate=True) (PyTorch's sorting path) and one
    index_add_ (the atomic scatter the plain version uses) over the four
    corners' indices and masses, `library_ms` the faster.  The flips are
    also counted on flow-shaped coordinates (`_coords`: a smooth
    displacement plus noise, so the mass of neighbours overlaps), where a
    pixel may lie within rounding of 0.95; they are reported, not required
    to be 0 (`run_training` requires 0 on the step's own coordinates).
    There the kernel is also timed (`flow_ms`): its atomics collide where
    neighbouring pixels scatter."""
    from endodav_tpu_torch.kernels import warp_matmul as W

    h, w = hw
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    x, y = _splat_coords(g, n, h, w, device)
    cot = torch.randn((n, h, w), generator=g, device=device)

    def run(fn):
        xs, ys = x.clone().requires_grad_(), y.clone().requires_grad_()
        occ = fn(xs, ys)
        return (occ.detach(), *torch.autograd.grad(occ, (xs, ys), cot))

    got = run(lambda a, b: W.splat_mm(a, b, h, w))
    want = run(lambda a, b: W.splat_reference(a, b, h, w))
    torch.cuda.synchronize(device)
    flips = int(((got[0] > 0.95) != (want[0] > 0.95)).sum())
    row = dict(shape=f"coords [{n},{h * w}] -> occ [{n},{h},{w}]", rel_occ=_rel_err(got[0], want[0]),
               err_occ=(got[0] - want[0]).abs().max().item(),
               err_dx=(got[1] - want[1]).abs().max().item(),
               err_dy=(got[2] - want[2]).abs().max().item(), flips=flips)
    require(row["rel_occ"] <= ATOMIC_RTOL, f"splat: relative err {row['rel_occ']}")
    require(flips == 0, f"splat: {flips} pixels change sides of occ > 0.95")
    for k in ("err_dx", "err_dy"):
        require(row[k] <= WARP_TOL, f"splat: {k} {row[k]} above {WARP_TOL}")
    fx, fy = _coords(g, n, h, w, device)
    flow = splat_agreement(fx.reshape(n, -1), fy.reshape(n, -1), h, w)
    row.update({f"flow_{k}": v for k, v in flow.items()})
    require(flow["rel_occ"] <= ATOMIC_RTOL,
            f"splat, flow-shaped coordinates: relative err {flow['rel_occ']}")

    t = time_calls({"plain": lambda: W.splat_reference(x, y, h, w),
                    "kernel": lambda: W.splat_cuda(x, y, h, w),
                    **splat_library_calls(x, y, h, w)})
    row.update(ms=t["kernel"], plain_ms=t["plain"], index_put_ms=t["index_put_"],
               index_add_ms=t["index_add_"])
    row["library_call"] = min(("index_put_", "index_add_"), key=t.get)
    row["library_ms"] = t[row["library_call"]]
    # coordinates read once, the map written once
    row["bound_ms"], row["bound_by"] = bound(4 * (2 * n * h * w + n * h * w), 40.0 * n * h * w)
    print(f"[splat] {row}")
    return row


def check_fused_rcu(device, shapes=RCU_SHAPES, timing=True):
    """The fused RCU against its plain version at the vits and vitb heads'
    RCU shapes, f32 and bf16, to TOL of max(1, the largest entry); the
    library yardstick is cuDNN's channels-last composition (two F.conv2d,
    relu, add) on the same tensors."""
    import torch.nn.functional as F

    from endodav_tpu_torch.kernels.fused_rcu import fused_rcu, rcu_reference

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    conv_sets = {}
    for c in sorted({shape[-1] for shape in shapes}):
        convs = conv_sets[c] = [torch.nn.Conv2d(c, c, 3, padding=1).to(device)
                                for _ in range(2)]
        with torch.no_grad():
            for conv in convs:
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=device)
                                  * (9 * c) ** -0.5)
                conv.bias.copy_(torch.randn(c, generator=g, device=device) * 0.1)
    for b, h, w, c in shapes:
        convs = conv_sets[c]
        x = torch.randn((b, h, w, c), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            ws = [p.to(dtype) for conv in convs for p in (conv.weight, conv.bias)]
            wf = [p.float() for p in ws]
            with torch.no_grad():
                want = rcu_reference(xd.float(), wf[0], convs[0].bias, wf[2], convs[1].bias)
                got = fused_rcu(xd, *convs).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            tol = TOL[dtype] * max(1.0, want.abs().max().item())
            row = dict(shape=f"[{b},{h},{w},{c}]", dtype=str(dtype)[6:], err=err)
            if timing:
                # cuDNN on channels-last NCHW views, weights channels-last too
                xl = xd.permute(0, 3, 1, 2)
                wl = [ws[i].contiguous(memory_format=torch.channels_last) for i in (0, 2)]

                def library():
                    y = F.conv2d(F.relu(xl), wl[0], ws[1], padding=1)
                    return F.conv2d(F.relu(y), wl[1], ws[3], padding=1) + xl

                with torch.no_grad():
                    t_ = time_calls({"plain": lambda: rcu_reference(xd, *ws),
                                     "kernel": lambda: fused_rcu(xd, *convs),
                                     "library": library})
                row["ms"], row["plain_ms"], row["library_ms"] = (t_["kernel"], t_["plain"],
                                                                 t_["library"])
                # x read and the output written once, the two tap sets and
                # biases once; two 3x3 convolutions a pixel
                tensor_core_bounds(
                    row, xd.element_size() * (2 * b * h * w * c + 2 * 9 * c * c) + 2 * 4 * c,
                    2.0 * b * h * w * 2 * 9 * c * c, dtype)
            print(f"[fused_rcu] {row}")
            require(err <= tol, f"fused_rcu {row}: max |err| above {tol}")
            rows.append(row)
    return rows


def check_temporal_attention(device, shapes=TATTN_SHAPES, heads=8, timing=True):
    """Temporal attention against its plain version at the training step's
    (T=16) and the 518x644 serving shapes (T=32), f32 and bf16, and the
    gradient of the kernel path against the plain version's autograd at a
    training shape; the library yardstick is scaled_dot_product_attention
    on [B*, H, T, Dh] copies made outside the timing."""
    import torch.nn.functional as F

    from endodav_tpu_torch.kernels.temporal_attention import (temporal_attention,
                                                              temporal_attention_reference)

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    for nrows, t, dh in shapes:
        qkv = [torch.randn((nrows, t, heads, dh), generator=g, device=device) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (a.to(dtype) for a in qkv)
            want = temporal_attention_reference(q.float(), k.float(), v.float(), dh ** -0.5)
            got = temporal_attention(q, k, v).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            row = dict(shape=f"rows={nrows} T={t} H={heads} Dh={dh}", dtype=str(dtype)[6:],
                       err=err)
            if timing:
                qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
                t_ = time_calls({
                    "plain": lambda: temporal_attention_reference(q, k, v, dh ** -0.5),
                    "kernel": lambda: temporal_attention(q, k, v),
                    "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
                row["ms"], row["plain_ms"], row["library_ms"] = (t_["kernel"], t_["plain"],
                                                                 t_["library"])
                # q, k, v read and the output written once; QK^T and PV
                row["bound_ms"], row["bound_by"] = bound(
                    q.element_size() * 4 * nrows * t * heads * dh,
                    4.0 * nrows * heads * t * t * dh, dtype)
                # the device's own time of the kernel and of SDPA's kernels
                # (torch.profiler), apart from the host's time a call, which
                # bounds back-to-back calls at the small training shapes
                for key, fn in (("device_ms", lambda: temporal_attention(q, k, v)),
                                ("library_device_ms",
                                 lambda: F.scaled_dot_product_attention(qh, kh, vh))):
                    split = device_ms_by_kernel(fn)
                    row[key] = sum(split.values()) if split else None
            print(f"[temporal_attention] {row}")
            require(err <= TOL[dtype], f"temporal_attention {row}: max |err| above {TOL[dtype]}")
            rows.append(row)
    # the gradient at a training shape, f32; and in bf16 at the three shapes
    # of the bf16 training step (--compute_dtype bfloat16), against the
    # plain version's autograd in f32 on the same bf16 inputs
    grad_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, grad_shapes in ((torch.float32, shapes[:1]), (torch.bfloat16, shapes[:3])):
        for nrows, t, dh in grad_shapes:
            qkv = [torch.randn((nrows, t, heads, dh), generator=g, device=device).to(dtype)
                   for _ in range(3)]
            cot = torch.randn((nrows, t, heads, dh), generator=g, device=device).to(dtype)
            got_in = [a.clone().requires_grad_() for a in qkv]
            out = temporal_attention(*got_in)
            require(out.grad_fn is not None,
                    "temporal_attention returned a result without grad_fn")
            got = torch.autograd.grad(out, got_in, cot)
            ref_in = [a.float().requires_grad_() for a in qkv]
            want = torch.autograd.grad(temporal_attention_reference(*ref_in, dh ** -0.5),
                                       ref_in, cot.float())
            err = max((a.float() - b).abs().max().item() for a, b in zip(got, want))
            scale = max(b.abs().max().item() for b in want)
            print(f"[temporal_attention grad] rows={nrows} T={t} Dh={dh} {str(dtype)[6:]}: "
                  f"max |err| {err:.3e} (largest entry {scale:.3e})")
            require(all(a.dtype == dtype for a in got) and err <= TOL[dtype] * max(1.0, scale),
                    f"temporal_attention gradient rows={nrows} Dh={dh} {dtype}: max |err| {err}")
            grad_err[dtype] = max(grad_err[dtype], err)
    return rows, grad_err


# the warp calls of the training step with C > 1 (CP_CALLS: name in
# WARP_CALLS): colour synthesis (forward and coordinate backward on the
# step under ENDODAV_WARP_CP=1) and JAX's flow-consistency call (the fused
# backward at C=2; the step's own fused backward is C=1)
CP_CALLS = ("colour synthesis", "flow_consistency")


def check_warps_cp(device, hw=TRAIN_HW):
    """The channel-plane warp kernels (ENDODAV_WARP_CP=1) against their
    plain version (`grid_sample_planes_reference`) and against the
    interleaved kernels on the same inputs, at the training step's C > 1
    warp calls; the times of the plane kernels, the interleaved kernels,
    the plain version and the library calls."""
    import torch.nn.functional as F

    from endodav_tpu_torch.kernels import warp_matmul as W

    h, w = hw
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    rows = []
    for name, b_img, c, tile, zeros, align, img_grad in WARP_CALLS:
        if name not in CP_CALLS:
            continue
        bg = b_img * tile
        img = torch.rand((b_img, h, w, c), generator=g, device=device)
        fx, fy = _coords(g, bg, h, w, device)
        cot = torch.randn((bg, h, w, c), generator=g, device=device)

        def grads(fn, cp):
            with _env({"ENDODAV_WARP_CP": "1" if cp else "0"}):
                i, x, y = (t.clone().requires_grad_() for t in (img, fx, fy))
                out = fn(i if img_grad else i.detach(), x, y)
                wrt = [x, y] + ([i] if img_grad else [])
                return (out.detach(), *torch.autograd.grad(out, wrt, cot))

        got = grads(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile), True)
        plain = grads(lambda i, x, y: W.grid_sample_planes_reference(
            W.to_planes(i), x, y, zeros, tile), True)
        inter = grads(lambda i, x, y: W.grid_sample_mm(i, x, y, zeros, img_grad, tile), False)
        torch.cuda.synchronize(device)
        row = dict(call=name, shape=f"img [{b_img},{c},{h},{w}] coords [{bg},{h},{w}]",
                   img_tile=tile, zeros=zeros)
        for label, want in (("plain", plain), ("interleaved", inter)):
            for k, what in enumerate(("out", "dfx", "dfy")):
                e = (got[k] - want[k]).abs().max().item()
                row[f"err_{what}_vs_{label}"] = e
                tol = WARP_TOL * max(1.0, want[k].abs().max().item())
                require(e <= tol, f"{name} planes: {what} vs {label} max |err| {e} above {tol}")
            if img_grad:
                rel = _rel_err(got[3], want[3])
                row[f"rel_dimg_vs_{label}"] = rel
                require(rel <= ATOMIC_RTOL, f"{name} planes: d_img vs {label} relative {rel}")
        row["fit_share"] = W.tile_fit_share(fx, fy, h, w, c)
        if img_grad:  # the last plane launch: `got`'s
            row["kernel_fit_share"] = kernel_fit_share(W.grid_sample_bwd_fused_cp_cuda, row)

        planes = W.to_planes(img)
        inp, grid, pad = _library_inputs(img, fx, fy, tile, align, zeros)
        fwd = time_calls({
            "plain": lambda: W.grid_sample_planes_reference(planes, fx, fy, zeros, tile),
            "kernel": lambda: W.grid_sample_fwd_cp_cuda(planes, fx, fy, zeros, tile),
            "interleaved": lambda: W.grid_sample_fwd_cuda(img, fx, fy, zeros, tile),
            "library": lambda: F.grid_sample(inp, grid, "bilinear", pad, align)})
        i, x, y = (t.clone().requires_grad_() for t in (planes, fx, fy))
        plain_out = W.grid_sample_planes_reference(i if img_grad else i.detach(), x, y, zeros,
                                                   tile)
        wrt = [x, y] + ([i] if img_grad else [])
        cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
        if img_grad:
            kernel, inter_k = (
                (lambda: W.grid_sample_bwd_fused_cp_cuda(planes, fx, fy, cot, zeros)),
                (lambda: W.grid_sample_bwd_fused_cuda(img, fx, fy, cot, zeros)))
        else:
            kernel, inter_k = (
                (lambda: W.grid_sample_bwd_coord_cp_cuda(planes, fx, fy, cot, zeros, tile)),
                (lambda: W.grid_sample_bwd_coord_cuda(img, fx, fy, cot, zeros, tile)))
        bwd = time_calls({
            "plain": lambda: torch.autograd.grad(plain_out, wrt, cot, retain_graph=True),
            "kernel": kernel, "interleaved": inter_k,
            "library": lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_nchw, inp, grid, 0, 0 if zeros else 1, align, [img_grad, True])})
        p, img_b, c4 = bg * h * w, b_img * h * w * c * 4, c * 4
        row["fwd"] = dict(ms=fwd["kernel"], interleaved_ms=fwd["interleaved"],
                          plain_ms=fwd["plain"], library_ms=fwd["library"])
        row["fwd"]["bound_ms"], row["fwd"]["bound_by"] = bound(img_b + p * (8 + c4),
                                                               p * (16 + 8 * c))
        row["bwd"] = dict(ms=bwd["kernel"], interleaved_ms=bwd["interleaved"],
                          plain_ms=bwd["plain"], library_ms=bwd["library"])
        row["bwd"]["bound_ms"], row["bwd"]["bound_by"] = bound(
            img_b * (2 if img_grad else 1) + p * (16 + c4), p * (16 + 16 * c))
        print(f"[warp planes] {row}")
        rows.append(row)
        del plain_out, wrt
    return rows


def eval_options(args):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse(["--seed", str(SEED), *args])


def _disp_err(a, b) -> tuple[float, float]:
    """(max, mean) |a - b| of two disparity tensors or arrays."""
    d = (torch.as_tensor(a).float().cpu() - torch.as_tensor(b).float().cpu()).abs()
    return d.max().item(), d.mean().item()


def check_whole_model(device, args=(), image_shape=(224, 280), frames=8, env=None,
                      pos_embedding_type="ape", expect=None, dtype=torch.float32,
                      rebuild=None):
    """A full-width EndoDAV on the card (kernels; int8 off, as
    build_depth_model leaves it) vs the CPU (plain versions), with ``env``
    set for both forwards, under the f32 policy that build_depth_model
    sets; ``pos_embedding_type="rope"`` clones the engine's model with RoPE
    motion modules; ``rebuild`` (model -> model) replaces the engine's
    model before both forwards.  ``args`` may pick EndoDAC or AF-SfM
    (``--model_type``), which take the clip's frames as one batch.
    ``expect`` maps kernel wrappers to the launches each must make in the
    card's forward.

    f32: disparity within MODEL_TOL of the CPU's.  bf16 (the engine's model
    cloned with ``dtype=torch.bfloat16``): against the CPU's f32 forward,
    the card's largest and mean |Δdisp| within BF16_REL_MAX and
    BF16_REL_MEAN times the CPU bf16 plain version's own, scale by scale;
    the card against the CPU at bf16 is printed beside BF16_MAX/BF16_MEAN
    (see there)."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.models.lora import dash_phase2_of

    opt = eval_options(["--no_cuda", "--depth_image_shape", *map(str, image_shape), *args])
    expect = expect or {}
    bf16 = dtype == torch.bfloat16
    with _env(env or {}):
        cpu_model = own_policy(f"build_depth_model, {pos_embedding_type}",
                               engine.build_depth_model, opt, torch.device("cpu"))
        if pos_embedding_type != "ape":
            cpu_model = cpu_model.clone(pos_embedding_type=pos_embedding_type)
        if rebuild is not None:
            cpu_model = rebuild(cpu_model)
            rebuilt = (f"lora_type={getattr(cpu_model, 'lora_type', None)}"
                       + (" dash phase 2" if dash_phase2_of(cpu_model) else ""))
        plain_model = cpu_model.clone(dtype=dtype) if bf16 else cpu_model
        gpu_model = copy.deepcopy(plain_model).to(device)
        rng = np.random.default_rng(SEED)
        video = torch.from_numpy(rng.uniform(0.0, 1.0, (1, frames, 256, 320, 3))
                                 .astype(np.float32))
        with torch.inference_mode():
            want = cpu_model(video)
            plain = plain_model(video) if bf16 else want
            for fn in expect:
                fn.launches = 0
            got = gpu_model(video.to(device))
            names = {fn: name for name, fn in _serving_counters().items()}
            launches = {names[fn]: fn.launches for fn in expect}
    label = " ".join([*(f"{k}={v}" for k, v in (env or {}).items()), opt.model_type,
                      opt.encoder, *args, pos_embedding_type, str(dtype)[6:]]
                     + ([f"rebuilt ({rebuilt})"] if rebuild is not None else []))
    row = {"label": label, "launches": launches}
    for s in range(4):
        card = _disp_err(got[("disp", s)], want[("disp", s)])
        row[s] = {"card": card}
        if bf16:
            require(got[("disp", s)].dtype == dtype, f"whole model {label}: output not {dtype}")
            own = _disp_err(plain[("disp", s)], want[("disp", s)])
            row[s].update(plain=own, card_vs_plain=_disp_err(got[("disp", s)],
                                                             plain[("disp", s)]))
            require(np.isfinite(card[0]) and card[0] <= BF16_REL_MAX * own[0]
                    and card[1] <= BF16_REL_MEAN * own[1],
                    f"whole model {label} scale {s}: |Δdisp| against f32 (max, mean) {card}, "
                    f"above {BF16_REL_MAX}x / {BF16_REL_MEAN}x the plain bf16 version's {own}")
        else:
            require(np.isfinite(card[0]) and card[0] <= MODEL_TOL,
                    f"whole model {label} scale {s}: max |Δdisp| {card[0]} above {MODEL_TOL}")
    per_scale = {s: row[s] for s in range(4)}
    note = ""
    if bf16:
        within = all(row[s]["card_vs_plain"][0] <= BF16_MAX
                     and row[s]["card_vs_plain"][1] <= BF16_MEAN for s in range(4))
        note = (f"; card vs plain bf16 {'within' if within else 'above'} the CPU test's "
                f"absolute bound ({BF16_MAX}, {BF16_MEAN})")
    print(f"[whole model] {label} {image_shape} T={frames}: (max, mean) |Δdisp| per scale "
          f"{per_scale}, launches {launches}{note}")
    for fn, n in expect.items():
        require(launches[names[fn]] == n,
                f"whole model {label}: {names[fn]} {launches[names[fn]]} launches, expected {n}")
    del cpu_model, plain_model, gpu_model
    row["max"] = max(row[s]["card"][0] for s in range(4))
    return row


def half_size(sequences):
    """The sequences subsampled 2x in each direction (AF-SfM takes frames
    at its training size, 256x320 for 512x640 sources)."""
    from endodav_tpu_torch.data.pipeline import pixel_intrinsics

    out = []
    for seq in sequences:
        colors = np.ascontiguousarray(seq["colors"][:, ::2, ::2])
        n, h, w, _ = colors.shape
        out.append({**seq, "colors": colors,
                    "depths": np.ascontiguousarray(seq["depths"][:, ::2, ::2]),
                    "Ks": pixel_intrinsics(n, h, w)})
    return out


def synthetic_sequences(n_seq=2, n_frames=64, h=512, w=640):
    """SCARED-like sequences made with numpy from the seed: smooth uint8
    frames, depths in (1, 150), small camera motion, SCARED intrinsics."""
    from endodav_tpu_torch.data.pipeline import pixel_intrinsics

    rng = np.random.default_rng(SEED)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    seqs = []
    for s in range(n_seq):
        phase = rng.uniform(0, 2 * np.pi, (3,))
        t = np.arange(n_frames)[:, None, None]
        colors = np.stack([128 + 100 * np.sin(6 * xx[None] + 4 * yy[None] + 0.05 * t + phase[c])
                           for c in range(3)], axis=-1).astype(np.uint8)
        depths = (40 + 30 * yy[None] + 10 * np.cos(3 * xx[None] + 0.03 * t)).astype(np.float32)
        poses = np.repeat(np.eye(4)[None], n_frames, axis=0)
        poses[:, 0, 3] = 0.1 * np.arange(n_frames)
        seqs.append({"colors": colors, "depths": depths, "poses": poses,
                     "Ks": pixel_intrinsics(n_frames, h, w), "filename": f"synthetic{s}"})
    return seqs


def _serving_counters():
    from endodav_tpu_torch.kernels import fused_temporal_block as ftb
    from endodav_tpu_torch.kernels.flash_attention import qkv_attention
    from endodav_tpu_torch.kernels.fused_mlp import fused_mlp
    from endodav_tpu_torch.kernels.fused_rcu import fused_rcu
    from endodav_tpu_torch.kernels.temporal_attention import temporal_attention

    return {"flash_attention": qkv_attention, "fused_temporal_block": ftb.fused_temporal_block,
            "fused_mlp": fused_mlp, "fused_rcu": fused_rcu,
            "temporal_attention": temporal_attention}


def rcu_routed(model) -> bool:
    """The RCUs of ``model``'s head take the fused kernel at serving
    (models/dpt.py): ENDODAV_FUSED_RCU, features <= 128 and no BatchNorm;
    AF-SfM has no DPT head."""
    from endodav_tpu_torch.kernels.fused_rcu import MAX_CHANNELS
    from endodav_tpu_torch.models.endodac import ENDODAC_CONFIGS
    from endodav_tpu_torch.models.endodav import ENDODAV_CONFIGS
    from endodav_tpu_torch.utils.envflags import env_on

    if model.model_type == "afsfm":
        return False
    if model.model_type == "endodac":
        features = ENDODAC_CONFIGS[model.backbone_size]["features"]
        if model.config["use_bn"]:
            return False
    else:
        features = ENDODAV_CONFIGS[model.encoder]["features"]
    return env_on("ENDODAV_FUSED_RCU") and features <= MAX_CHANNELS


# the RCUs of one head suffix: refinenet1-3 two each, refinenet4 one
RCU_PER_SUFFIX = 7
# frames a forward of the single-frame paths (infer_video_depth_single_frame,
# cli/evaluate_depth)
SINGLE_FRAME_BATCH = 8


def wide_temporal_blocks(model) -> int:
    """Temporal blocks a window runs at C >= 512, the TPU's grouped kernel
    (row 3 of PERF.md's table): two a motion module of that width.  The
    others are row 2's; one counter counts both."""
    return 2 * sum(m.temporal_transformer.norm.num_channels >= 512
                   for m in model.head.motion_modules)


def expected_serving_launches(opt, forward, sequences):
    """Launches of each serving kernel in one run, from the configuration
    (a single-frame model: per batch of frames, see below): per encode
    batch (dedup) or per window chunk (window path) one flash
    attention a ViT block, and one fused MLP a block where it routes; per
    window chunk two temporal blocks a motion module (four modules, at
    every width on the one tensor-core route), and one head suffix
    (whatever the number of windows in it): seven fused RCUs where they
    route.  The serving models are APE: no temporal attention."""
    from endodav_tpu_torch.eval.video_inference import window_indices
    from endodav_tpu_torch.models.vit import VIT_CONFIGS
    from endodav_tpu_torch.ops.quant import resolve_int8
    from endodav_tpu_torch.utils.envflags import env_on

    model = forward.model
    if model.model_type != "endodav":
        # single-frame batches of SINGLE_FRAME_BATCH: a flash attention a ViT
        # block (EndoDAC), one head (seven RCUs where they route) a batch
        batches = sum(-(-len(s["colors"]) // SINGLE_FRAME_BATCH) for s in sequences)
        depth = (VIT_CONFIGS[model.backbone_size]["depth"] if model.model_type == "endodac"
                 else 0)
        mlp = (depth and env_on("ENDODAV_FUSED_MLP") and model.lora_type == "none"
               and not resolve_int8(False))
        return ({"flash_attention": depth * batches, "fused_temporal_block": 0,
                 "fused_mlp": depth * batches if mlp else 0,
                 "fused_rcu": RCU_PER_SUFFIX * batches if rcu_routed(model) else 0,
                 "temporal_attention": 0},
                dict(chunks=0, encode_batches=batches, wide_temporal=0))
    depth = VIT_CONFIGS[opt.encoder]["depth"]
    chunks = sum(-(-len(window_indices(len(s["colors"]))) // opt.chunk_windows) for s in sequences)
    dedup = forward.dedup
    batches = (sum(-(-len(s["colors"]) // dedup.encode_batch_for(len(s["colors"])))
                   for s in sequences) if dedup is not None else chunks)
    mlp = (env_on("ENDODAV_FUSED_MLP") and forward.model.lora_type == "none"
           and not resolve_int8(forward.model.int8_serving))
    return ({"flash_attention": depth * batches, "fused_temporal_block": 8 * chunks,
             "fused_mlp": depth * batches if mlp else 0,
             "fused_rcu": RCU_PER_SUFFIX * chunks if rcu_routed(forward.model) else 0,
             "temporal_attention": 0},
            dict(chunks=chunks, encode_batches=batches if dedup is not None else 0,
                 wide_temporal=wide_temporal_blocks(forward.model) * chunks))


def run_main_path(args, sequences, device, env=None):
    """build_depth_model -> depth_window_forward -> evaluate_video_sequences
    with ``env`` set for the run, the serving kernels' launch counts set
    to 0 just before and read just after, and checked."""
    from endodav_tpu_torch.cli.evaluate_depth_video import report
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth_single_frame

    env = env or {}
    with _env(env):
        opt = eval_options(args)
        forward = engine.depth_window_forward(
            own_policy("build_depth_model", engine.build_depth_model, opt, device))
        counters = _serving_counters()
        torch.cuda.reset_peak_memory_stats(device)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = engine.evaluate_video_sequences(opt, sequences, forward, device=device)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        expect, passes = expected_serving_launches(opt, forward, sequences)
        if opt.model_type != "endodav":
            # the run above is the CLI's cold one (cuDNN meets each
            # convolution shape there first); the same frames again, warm
            frames = sequences[0]["colors"]
            t0 = time.perf_counter()
            infer_video_depth_single_frame(forward, frames, device=device)
            passes["warm_ms_per_frame"] = (time.perf_counter() - t0) / len(frames) * 1e3
    name = " ".join(f"{k}={v}" for k, v in env.items()) + " " + (" ".join(args) or "CLI default")
    for line in report(result):
        print(f"[main path {name.strip()}] {line}")
    print(f"[main path] {passes} dedup={forward.dedup is not None} "
          f"prefix_mode={getattr(forward.dedup, 'prefix_mode', None)} "
          f"int8={getattr(forward.model, 'int8_serving', False)} launches={launches} "
          f"wall={wall:.3f} s "
          f"peak {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    vals = np.concatenate([result["mean_errors"], result["mean_temporal"]])
    require(bool(np.all(np.isfinite(vals))), f"main path metrics not finite: {vals}")
    require(launches == expect, f"main path {name}: launches {launches}, expected {expect}")
    return {"args": args, "name": name.strip(), "ms_per_frame": result["mean_infer_ms"],
            "launches": launches, **passes, "metrics": [float(v) for v in vals]}


def run_evaluate_depth(device, args=ENDODAC_VITB, n_frames=16, h=512, w=640):
    """`cli/evaluate_depth.evaluate` on a synthetic SCARED ``endovis`` tree
    written from the seed to a temporary directory: PNG frames through PIL,
    and ``endovis/test_files.txt`` with ``gt_depths.npz`` in a temporary
    split directory named by ENDODAV_TPU_SPLITS_DIR (no depth TIFF is read,
    so no cv2).  The serving kernels' launches are set to 0 just before and
    read just after; finite metrics required."""
    from PIL import Image

    from endodav_tpu_torch.cli import evaluate_depth
    from endodav_tpu_torch.models.vit import VIT_CONFIGS

    seq = synthetic_sequences(n_seq=1, n_frames=n_frames, h=h, w=w)[0]
    folder = "dataset3/keyframe1"
    with tempfile.TemporaryDirectory(prefix="endovis_") as root:
        left = os.path.join(root, "data", "train", folder, "data", "left")
        os.makedirs(left)
        for i, frame in enumerate(seq["colors"]):
            Image.fromarray(frame).save(os.path.join(left, f"{i:010d}.png"))
        split = os.path.join(root, "splits", "endovis")
        os.makedirs(split)
        with open(os.path.join(split, "test_files.txt"), "w") as f:
            f.write("".join(f"{folder} {i} l\n" for i in range(n_frames)))
        np.savez(os.path.join(split, "gt_depths.npz"), data=seq["depths"])
        with _env({"ENDODAV_TPU_SPLITS_DIR": os.path.join(root, "splits")}):
            opt = eval_options([*args, "--eval_split", "endovis", "--data_path",
                                os.path.join(root, "data")])
            counters = _serving_counters()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            errors = own_policy("evaluate_depth", evaluate_depth.evaluate, opt)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
    batches = -(-n_frames // SINGLE_FRAME_BATCH)
    flash = 0 if opt.model_type == "afsfm" else VIT_CONFIGS[opt.encoder]["depth"] * batches
    print(f"[evaluate_depth] {' '.join(args)}: {n_frames} frames {h}x{w}, errors "
          f"{errors.tolist() if errors is not None else None}, launches {launches}, "
          f"wall {wall:.3f} s")
    require(errors is not None and bool(np.all(np.isfinite(errors))),
            f"evaluate_depth: metrics not finite: {errors}")
    require(launches["flash_attention"] == flash,
            f"evaluate_depth: {launches['flash_attention']} flash launches, expected {flash}")
    return {"name": "evaluate_depth " + " ".join(args), "launches": launches, "wall_s": wall,
            "ms_per_frame": wall * 1e3 / n_frames, "errors": errors.tolist()}


def check_test_simple(device, args=ENDODAC_VITB, h=512, w=640):
    """`cli/test_simple.predict_disparity` (one frame of the synthetic
    sequence, at its own size) on the card against the CPU, to MODEL_TOL,
    with a flash attention a ViT block launched."""
    from endodav_tpu_torch.cli import test_simple
    from endodav_tpu_torch.eval import engine

    opt = test_simple.parse_args(["--image_path", "-", "--no_cuda", "--seed", str(SEED), *args])
    cpu_model = own_policy("test_simple", engine.build_depth_model, opt)
    gpu_model = copy.deepcopy(cpu_model).to(device)
    image = synthetic_sequences(n_seq=1, n_frames=1, h=h, w=w)[0]["colors"][0]
    flash = _serving_counters()["flash_attention"]
    flash.launches = 0
    got = test_simple.predict_disparity(gpu_model, image)
    launches = flash.launches
    want = test_simple.predict_disparity(cpu_model, image)
    err = _disp_err(got, want)
    print(f"[test_simple] {' '.join(args)}: disparity {tuple(got.shape)} card vs CPU (max, mean) "
          f"{err}, flash launches {launches}")
    require(tuple(got.shape) == (h, w) and err[0] <= MODEL_TOL,
            f"test_simple: disparity {tuple(got.shape)}, max |Δdisp| {err[0]} above {MODEL_TOL}")
    require(launches == 12, f"test_simple: {launches} flash launches, expected 12")
    return err[0]


def check_switches(device):
    """The JAX engine's A/B switches on the card, each an explicit leg:
    ENDODAV_NO_FLASH (EndoDAC: no flash launch) and ENDODAV_LOWRES_OUTCONV
    (EndoDAC: unchanged within MODEL_TOL of the card's reference order);
    ENDODAV_NO_FUSED (EndoDAV: no temporal block, the unfused route's
    temporal attention) through `check_whole_model`; ENDODAV_FUSED_TRAIN (a
    training-route motion module takes the fused block, forward and
    gradient against the CPU) and ENDODAV_NO_WARP_MM (the warp and the
    splat take their plain versions: no warp launch, the same values)."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.kernels import warp_matmul as W
    from endodav_tpu_torch.models.motion import TemporalModule
    from endodav_tpu_torch.ops import sampling

    counters = _serving_counters()
    flash, block = counters["flash_attention"], counters["fused_temporal_block"]
    tattn = counters["temporal_attention"]
    rows = {}
    opt = eval_options([*ENDODAC, "--no_cuda"])
    model = copy.deepcopy(own_policy("build_depth_model, switches", engine.build_depth_model,
                                     opt, torch.device("cpu"))).to(device)
    video = torch.from_numpy(np.random.default_rng(SEED).uniform(0.0, 1.0, (8, 256, 320, 3))
                             .astype(np.float32)).to(device)
    outs = {}
    for name, env in (("reference", {}), ("ENDODAV_NO_FLASH", {"ENDODAV_NO_FLASH": "1"}),
                      ("ENDODAV_LOWRES_OUTCONV", {"ENDODAV_LOWRES_OUTCONV": "1"})):
        with _env(env), torch.inference_mode():
            flash.launches = 0
            outs[name] = model(video)
            rows[name] = {"flash_attention": flash.launches}
    for name in ("ENDODAV_NO_FLASH", "ENDODAV_LOWRES_OUTCONV"):
        err = max(_disp_err(outs[name][("disp", s)], outs["reference"][("disp", s)])[0]
                  for s in range(4))
        rows[name]["vs_reference"] = err
        require(err <= MODEL_TOL, f"{name}: EndoDAC moved {err} from the reference order")
    require(rows["reference"]["flash_attention"] == 12 and
            rows["ENDODAV_NO_FLASH"]["flash_attention"] == 0,
            f"switches: flash launches {rows}")
    rows["ENDODAV_NO_FUSED"] = check_whole_model(
        device, env={"ENDODAV_NO_FUSED": "1"}, frames=4, expect={block: 0, tattn: 8})["max"]

    # a vits motion module at a training window's 16x20 map, T=16
    g = torch.Generator().manual_seed(SEED + 11)
    module = TemporalModule(192)
    with torch.no_grad():
        for prm in module.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * prm[0].numel() ** -0.5)
    x = torch.randn((16, 16, 20, 192), generator=g)
    cot = torch.randn(x.shape, generator=g)
    grads = []
    with _env({"ENDODAV_FUSED_TRAIN": "1"}):
        for dev, mod in ((torch.device("cpu"), module),
                         (device, copy.deepcopy(module).to(device))):
            block.launches = tattn.launches = 0
            xd = x.to(dev).requires_grad_()
            out = mod(xd, 16, train=True)
            (dx,) = torch.autograd.grad(out, xd, cot.to(dev))
            grads.append((out.detach().cpu(), dx.cpu(), block.launches, tattn.launches))
    (out_c, dx_c, _, _), (out_g, dx_g, n_block, n_tattn) = grads
    err = max((out_g - out_c).abs().max().item(), (dx_g - dx_c).abs().max().item()
              / max(1.0, dx_c.abs().max().item()))
    rows["ENDODAV_FUSED_TRAIN"] = {"fused_temporal_block": n_block, "temporal_attention": n_tattn,
                                   "err": err}
    require(n_block == 2 and n_tattn == 0 and err <= TOL[torch.float32],
            f"ENDODAV_FUSED_TRAIN: {rows['ENDODAV_FUSED_TRAIN']}")

    # the training step's colour synthesis warp and occlusion splat
    gw = torch.Generator(device=device).manual_seed(SEED + 12)
    img = torch.rand((4, 256, 320, 3), generator=gw, device=device)
    flow = torch.randn((4, 256, 320, 2), generator=gw, device=device) * 3
    warps = {}
    for name, env in (("kernels", {}), ("ENDODAV_NO_WARP_MM", {"ENDODAV_NO_WARP_MM": "1"})):
        with _env(env):
            W.grid_sample_fwd_cuda.launches = W.splat_cuda.launches = 0
            warped = sampling.flow_warp(img, flow)
            occ = sampling.occlusion_mask_backward(flow)[1]
            warps[name] = (warped, occ, W.grid_sample_fwd_cuda.launches + W.splat_cuda.launches)
    err = max((warps["kernels"][0] - warps["ENDODAV_NO_WARP_MM"][0]).abs().max().item(),
              (warps["kernels"][1] - warps["ENDODAV_NO_WARP_MM"][1]).abs().max().item())
    rows["ENDODAV_NO_WARP_MM"] = {"warp_launches": warps["ENDODAV_NO_WARP_MM"][2],
                                  "kernel_launches": warps["kernels"][2], "err": err}
    require(warps["ENDODAV_NO_WARP_MM"][2] == 0 and warps["kernels"][2] == 2
            and err <= WARP_TOL * 10, f"ENDODAV_NO_WARP_MM: {rows['ENDODAV_NO_WARP_MM']}")
    print(f"[switches] {rows}")
    return rows


def run_streaming(args, sequence, device, env=None):
    """`DepthStreamer` as a live caller drives it: the engine's model and
    forward (dedup where the engine picks it), one frame pushed at a time
    with a synchronise after each push, then `flush`.  The launches of
    every serving kernel are set to 0 just before the stream and read just
    after; the streamed depth is held against `infer_video_depth(...,
    stitch="host")` on the card (1e-4) and the buffer against 2*INFER_LEN.
    Reports the median ms per push and per fired window (the push that
    fires one, its depth back on the host)."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.streaming import DepthStreamer
    from endodav_tpu_torch.eval.video_inference import infer_video_depth, window_indices
    from endodav_tpu_torch.models.endodav import INFER_LEN
    from endodav_tpu_torch.models.vit import VIT_CONFIGS

    frames = sequence["colors"]
    n = len(frames)
    env = env or {}
    with _env(env):
        opt = eval_options(args)
        forward = engine.depth_window_forward(
            own_policy("build_depth_model", engine.build_depth_model, opt, device))
        shape = tuple(opt.depth_image_shape)
        streamer = own_policy("DepthStreamer", DepthStreamer, forward, shape,
                              dedup=forward.dedup, device=device)
        counters = _serving_counters()
        for fn in counters.values():
            fn.launches = 0
        out, push_ms, window_ms, max_buf = [], [], [], 0
        torch.cuda.synchronize(device)
        for f in frames:
            t0 = time.perf_counter()
            new = streamer.push(f)
            torch.cuda.synchronize(device)
            push_ms.append((time.perf_counter() - t0) * 1e3)
            if new:
                window_ms.append(push_ms[-1])
            out.extend(new)
            max_buf = max(max_buf, streamer.frames_buffered)
        t0 = time.perf_counter()
        out.extend(streamer.flush())
        flush_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches for k, fn in counters.items()}
        rcu = rcu_routed(forward.model)
        offline = infer_video_depth(forward, frames, shape, opt.chunk_windows, device, "host",
                                    forward.dedup)
    got = np.stack(out)
    err = float(np.abs(got - offline).max())
    windows = len(window_indices(n))
    depth = VIT_CONFIGS[opt.encoder]["depth"]
    dedup = forward.dedup is not None
    # per push (dedup) or per window: one flash attention a ViT block; per
    # window two temporal blocks a motion module and one head suffix, seven
    # fused RCUs where they route
    expect = {"flash_attention": depth * (n if dedup else windows),
              "fused_temporal_block": 8 * windows, "fused_mlp": 0,
              "fused_rcu": RCU_PER_SUFFIX * windows if rcu else 0, "temporal_attention": 0}
    name = " ".join([*(f"{k}={v}" for k, v in env.items()), *args]) or "CLI default"
    row = {"name": name, "dedup": dedup, "frames": n, "windows": windows,
           "ms_per_push": statistics.median(push_ms), "ms_per_window": statistics.median(window_ms),
           "flush_ms": flush_ms, "max_buffered": max_buf, "err_vs_offline": err,
           "launches": launches, "wide_temporal": wide_temporal_blocks(forward.model) * windows}
    print(f"[streaming] {row} ({card_line()})")
    require(got.shape == offline.shape, f"streaming {name}: {got.shape} vs {offline.shape}")
    require(bool(np.all(np.isfinite(got))) and err <= 1e-4,
            f"streaming {name}: max |Δ| against offline {err}")
    require(max_buf <= 2 * INFER_LEN, f"streaming {name}: {max_buf} frames buffered")
    require(launches == expect, f"streaming {name}: launches {launches}, expected {expect}")
    return row


def plain_bf16_error(model, frames) -> tuple[float, float]:
    """(max, mean) |Δdisp| at scale 0 of the bf16 plain version against
    the f32 one: ``model`` (f32) copied to the CPU and its bf16 clone there,
    on ``frames`` (uint8 [T, H, W, 3]) as one clip."""
    cpu = copy.deepcopy(model).cpu()
    video = torch.from_numpy(frames[None].astype(np.float32) / 255.0)
    with torch.inference_mode():
        want = cpu(video)[("disp", 0)]
        got = cpu.clone(dtype=torch.bfloat16)(video)[("disp", 0)]
    del cpu
    return _disp_err(got, want)


def run_bf16_serving(args, sequence, device, plain_frames=0):
    """The TPU benchmark's headline way of serving (`bench.py:96-127`) at
    the configuration ``args``: the engine's seed-0 model
    (`build_depth_model`) and its ``clone(dtype=torch.bfloat16)``, each
    through `depth_window_forward` (dedup where the engine picks it, int8
    where it defaults to it) and `infer_video_depth` with the device
    stitch, f32 with an f32 transfer and bf16 with ``np.float16``.  After a
    warm-up run of each, timed in turns f32, bf16, bf16, f32: ms per source
    frame of each.  The bf16 runs' launches (set to 0 before them, read
    after) are checked against the configuration; the bf16 output against
    the f32 one: finite, and with ``plain_frames``, its (max, mean)
    |Δdisp| within BF16_REL_MAX / BF16_REL_MEAN times the CPU plain bf16
    version's own error on the sequence's first ``plain_frames`` frames."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth

    frames = sequence["colors"]
    opt = eval_options(args)
    shape = tuple(opt.depth_image_shape)
    model = own_policy("build_depth_model", engine.build_depth_model, opt, device)
    legs = {"f32": (engine.depth_window_forward(model), np.float32),
            "bf16": (engine.depth_window_forward(model.clone(dtype=torch.bfloat16)),
                     np.float16)}
    counters = _serving_counters()

    def run(name):
        fwd, transfer = legs[name]
        t0 = time.perf_counter()
        out = infer_video_depth(fwd, frames, shape, opt.chunk_windows, device, "device",
                                fwd.dedup, transfer_dtype=transfer)
        return out, (time.perf_counter() - t0) / len(frames) * 1e3

    outs = {name: run(name)[0] for name in legs}  # warm-up
    ms = {name: [] for name in legs}
    for name in ("f32", "bf16", "bf16", "f32"):
        if name == "bf16" and not ms["bf16"]:
            for fn in counters.values():
                fn.launches = 0
        outs[name], t = run(name)
        ms[name].append(t)
        if name == "bf16" and len(ms["bf16"]) == 2:
            launches = {k: fn.launches for k, fn in counters.items()}
    fwd16 = legs["bf16"][0]
    expect, passes = expected_serving_launches(opt, fwd16, [sequence])
    expect = {k: 2 * v for k, v in expect.items()}
    err = _disp_err(outs["bf16"], outs["f32"])
    row = {"name": " ".join(args), "frames": len(frames),
           "ms_per_frame": {k: statistics.mean(v) for k, v in ms.items()},
           "bf16_vs_f32": err, "launches": launches, "int8": fwd16.model.int8_serving,
           "dedup": fwd16.dedup is not None,
           "prefix_mode": getattr(fwd16.dedup, "prefix_mode", None),
           "wide_temporal": 2 * passes["wide_temporal"]}
    if plain_frames:
        row["plain_bf16_vs_f32"] = plain_bf16_error(model, frames[:plain_frames])
    print(f"[bf16 serving] {row} ({card_line()})")
    require(outs["bf16"].shape == (len(frames), *frames.shape[1:3])
            and bool(np.all(np.isfinite(outs["bf16"]))),
            f"bf16 serving {row['name']}: output {outs['bf16'].shape} not finite or misshapen")
    require(launches == expect, f"bf16 serving {row['name']}: launches {launches} in two runs, "
                                f"expected {expect}")
    if plain_frames:
        own = row["plain_bf16_vs_f32"]
        require(err[0] <= BF16_REL_MAX * own[0] and err[1] <= BF16_REL_MEAN * own[1],
                f"bf16 serving {row['name']}: (max, mean) |Δdisp| against f32 {err} above "
                f"{BF16_REL_MAX}x / {BF16_REL_MEAN}x the plain bf16 version's {own}")
    del legs, model
    return row


def run_sequential_baseline(sequence, device, n_frames=54):
    """The TPU benchmark's baseline leg (`bench.py:129-132`) on the headline
    configuration in f32: `infer_video_depth(sequential=True,
    chunk_windows=1, transfer_dtype=np.float32, stitch="host")` over the
    sequence's first ``n_frames`` frames (3 windows), against a batched run
    of the same frames with the same host stitch (the window path, two
    windows a chunk) to MODEL_TOL; ms per source frame of both (each after
    a warm-up run); the sequential run's launches, set to 0 before it and
    read after: per window one flash attention a ViT block and two
    temporal blocks a motion module."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth, window_indices
    from endodav_tpu_torch.models.vit import VIT_CONFIGS

    frames = sequence["colors"][:n_frames]
    opt = eval_options(HEADLINE)
    shape = tuple(opt.depth_image_shape)
    fwd = engine.depth_window_forward(
        own_policy("build_depth_model", engine.build_depth_model, opt, device))
    counters = _serving_counters()
    legs = {"sequential": dict(chunk_windows=1, sequential=True),
            "batched": dict(chunk_windows=2)}
    outs, ms = {}, {}
    for name, kw in legs.items():
        infer_video_depth(fwd, frames, shape, device=device, stitch="host", **kw)  # warm-up
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs[name] = infer_video_depth(fwd, frames, shape, device=device, stitch="host",
                                       transfer_dtype=np.float32, **kw)
        ms[name] = (time.perf_counter() - t0) / n_frames * 1e3
        if name == "sequential":
            launches = {k: fn.launches for k, fn in counters.items()}
    windows = len(window_indices(n_frames))
    expect = {"flash_attention": VIT_CONFIGS[opt.encoder]["depth"] * windows,
              "fused_temporal_block": 8 * windows, "fused_mlp": 0, "fused_rcu": 0,
              "temporal_attention": 0}
    err = _disp_err(outs["sequential"], outs["batched"])
    row = {"name": "sequential " + " ".join(HEADLINE), "frames": n_frames, "ms_per_frame": ms,
           "sequential_vs_batched": err, "launches": launches,
           "wide_temporal": wide_temporal_blocks(fwd.model) * windows}
    print(f"[sequential baseline] {row} ({card_line()})")
    require(bool(np.all(np.isfinite(outs["sequential"]))) and err[0] <= MODEL_TOL,
            f"sequential baseline: max |Δdisp| against the batched run {err[0]} above "
            f"{MODEL_TOL}")
    require(launches == expect, f"sequential baseline: launches {launches}, expected {expect}")
    del fwd
    return row


def run_shipped_eval(sequences, device):
    """The shipped eval's configuration (`SHIPPED_EVAL`: vits ssb at
    518x644, dedup by default) through the CLI's path (`run_main_path`,
    launches checked): as built (unmerged, as the scripts serve it), with
    --merge_lora, and merged with ENDODAV_FUSED_MLP=1 (the fused MLP a ViT
    block an encode batch).  Then both models warm on the first sequence
    in turns (as built, merged, merged, as built), `infer_video_depth` with
    the CLI's host stitch: ms per source frame of each, and the largest
    |Δdisp| between them within MODEL_TOL."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth

    runs = [run_main_path(SHIPPED_EVAL, sequences, device),
            run_main_path([*SHIPPED_EVAL, "--merge_lora"], sequences, device),
            run_main_path([*SHIPPED_EVAL, "--merge_lora"], sequences, device,
                          env={"ENDODAV_FUSED_MLP": "1"})]
    frames = sequences[0]["colors"]
    legs = {}
    for name, extra in (("as built", []), ("merged", ["--merge_lora"])):
        opt = eval_options([*SHIPPED_EVAL, *extra])
        legs[name] = (opt, engine.depth_window_forward(
            own_policy("build_depth_model", engine.build_depth_model, opt, device)))
    outs, ms = {}, {name: [] for name in legs}
    for name in ("as built", "merged", "merged", "as built"):
        opt, fwd = legs[name]
        t0 = time.perf_counter()
        outs[name] = infer_video_depth(fwd, frames, tuple(opt.depth_image_shape),
                                       opt.chunk_windows, device, "host", fwd.dedup)
        ms[name].append((time.perf_counter() - t0) / len(frames) * 1e3)
    err = _disp_err(outs["as built"], outs["merged"])
    row = {"ms_per_frame": ms, "as_built_vs_merged": err,
           "cli_ms_per_frame": {r["name"]: r["ms_per_frame"] for r in runs}}
    print(f"[shipped eval] {' '.join(SHIPPED_EVAL)}: warm ms/frame {ms}, (max, mean) |Δdisp| "
          f"as built vs merged {err} ({card_line()})")
    require(bool(np.all(np.isfinite(outs["as built"]))) and err[0] <= MODEL_TOL,
            f"shipped eval: as built vs merged max |Δdisp| {err[0]} above {MODEL_TOL}")
    del legs
    return runs, row


def write_scared_tree(root, n_frames=24, h=512, w=640, step=(3, 4)):
    """Left frames (PNG, through PIL) of every sequence of the training
    and val splits, made with numpy from the seed: a window drifting by
    `step` pixels a frame over a smooth texture with fine detail.  24
    frames a sequence give the 23 training sequences 33 clips of T=16 (the
    `Trainer` builds its val loader over the val sequences)."""
    from PIL import Image

    from endodav_tpu_torch.data.readers import readlines

    rng = np.random.default_rng(SEED)
    bh, bw = h + step[0] * n_frames, w + step[1] * n_frames
    yy, xx = np.meshgrid(np.linspace(0, bh / h, bh), np.linspace(0, bw / w, bw), indexing="ij")
    fine = rng.uniform(-12, 12, (bh, bw, 3))
    for name in readlines(SPLIT) + readlines(VAL_SPLIT):
        left = os.path.join(root, name, "data", "left")
        os.makedirs(left, exist_ok=True)
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([128 + 70 * np.sin(9 * xx + 5 * yy + phase[c])
                         + 30 * np.cos(23 * yy - 17 * xx) for c in range(3)], -1)
        base = np.clip(base + fine, 0, 255).astype(np.uint8)
        for i in range(n_frames):
            y0, x0 = step[0] * i, step[1] * i
            Image.fromarray(base[y0:y0 + h, x0:x0 + w]).save(
                os.path.join(left, f"{i:010d}.png"), compress_level=0)
    return root


def train_options(root, *extra):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse([*TRAIN_FLAGS, "--data_path", root, *extra])


def check_small_step(device, root, env=None, dtype="float32", extra=()):
    """One training step of a small configuration on the card (kernels)
    and on the CPU (plain versions), from the same seed weights and the
    same loader batch, with ``env`` set for both steps; with ``dtype``
    "bfloat16" both train in bf16 (``--compute_dtype``), held to the bf16
    bounds: losses BF16_LOSS_RTOL, gradients TOL[bf16] of their largest
    entry, the updates unchecked (Adam's first step moves every entry by
    about lr whatever its gradient's rounding)."""
    from endodav_tpu_torch.train.trainer import Trainer

    args = ["--height", "64", "--width", "96", "--T", "4", "--depth_image_shape", "56", "70",
            "--compute_dtype", dtype, *extra]
    bf16 = dtype == "bfloat16"
    gpu = own_policy("Trainer", Trainer, train_options(root, *args), device)
    cpu = own_policy("Trainer", Trainer, train_options(root, *args, "--no_cuda"))
    batch = next(iter(cpu.train_loader))
    with _env(env or {}):
        got = gpu.train_one_batch(batch)
        with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's reduced-precision convs
            want = cpu.train_one_batch(batch)
    errs = {}
    for k in ("loss_0", "loss"):
        a, b = float(got[k]), float(want[k])
        errs[k] = abs(a - b) / abs(b)
        require(np.isfinite(a) and errs[k] <= (BF16_LOSS_RTOL if bf16 else STEP_LOSS_RTOL),
                f"small step {dtype} {k}: card {a} vs CPU {b}, relative {errs[k]}")
    named = {"lora_B": ("depth_model", "pretrained.blocks.5.mlp.fc1.lora_B"),
             "pose_2": ("pose", "convs.pose_2.weight")}
    for label, (comp, pname) in named.items():
        pg = dict(gpu.mods[comp].named_parameters())[pname]
        pc = dict(cpu.mods[comp].named_parameters())[pname]
        require(pg.grad is not None and pc.grad is not None, f"small step: {pname} got no gradient")
        gg, gc = pg.grad.cpu(), pc.grad
        errs[f"grad {label}"] = (gg - gc).abs().max().item() / gc.abs().max().item()
        require(errs[f"grad {label}"] <= (TOL[torch.bfloat16] if bf16 else STEP_GRAD_RTOL),
                f"small step: gradient of {pname} relative err {errs[f'grad {label}']}")
        if bf16:
            continue
        sure = gc.abs() > 1e-3 * gc.abs().max()
        errs[f"update {label}"] = (pg.detach().cpu() - pc.detach())[sure].abs().max().item()
        require(errs[f"update {label}"] <= STEP_UPDATE_ATOL,
                f"small step: updated {pname} differs by {errs[f'update {label}']}")
    label = " ".join([f"{k}={v}" for k, v in (env or {}).items()] + [dtype] * bf16
                     + list(extra))
    print(f"[small step {label}] card vs CPU, 64x96 T=4 ViT 56x70: losses card "
          f"{float(got['loss_0']):.6f}/{float(got['loss']):.6f}, errors {errs}")
    return errs


def _kernel_counters():
    from endodav_tpu_torch.kernels import warp_matmul as W
    from endodav_tpu_torch.kernels.flash_attention import qkv_attention
    from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block
    from endodav_tpu_torch.kernels.temporal_attention import temporal_attention

    return {"grid_sample_fwd": W.grid_sample_fwd_cuda,
            "grid_sample_bwd_coord": W.grid_sample_bwd_coord_cuda,
            "grid_sample_bwd_fused": W.grid_sample_bwd_fused_cuda,
            "grid_sample_fwd_cp": W.grid_sample_fwd_cp_cuda,
            "grid_sample_bwd_coord_cp": W.grid_sample_bwd_coord_cp_cuda,
            "grid_sample_bwd_fused_cp": W.grid_sample_bwd_fused_cp_cuda, "splat": W.splat_cuda,
            "flash_attention": qkv_attention, "fused_temporal_block": fused_temporal_block,
            "temporal_attention": temporal_attention}


def run_training(device, root, steps=4, trace_dir=None):
    """`Trainer` at full width on the synthetic tree: `steps` steps of
    `train_one_batch`, then CP_STEPS more with ENDODAV_WARP_CP=1 (the
    channel-plane warps), each checked; returns the launches and times."""
    from endodav_tpu_torch.ops import sampling
    from endodav_tpu_torch.train.trainer import Trainer

    opt = train_options(root, "--height", str(TRAIN_HW[0]), "--width", str(TRAIN_HW[1]),
                        "--T", str(TRAIN_T))
    trainer = own_policy("Trainer", Trainer, opt, device)
    print(f"[train] {len(trainer.train_dataset)} clips of T={opt.T}, {len(trainer.train_loader)} "
          f"batches; flags {' '.join(TRAIN_FLAGS)}")
    params = {k: dict(m.named_parameters()) for k, m in trainer.mods.items()}
    watch = {"frozen": params["depth_model"]["pretrained.blocks.0.attn.qkv.weight"],
             "lora_B": params["depth_model"]["pretrained.blocks.5.mlp.fc1.lora_B"],
             "lora_U": params["depth_model"]["pretrained.blocks.5.mlp.fc1.lora_U"],
             "pose": params["pose"]["convs.pose_2.weight"]}
    counters = _kernel_counters()
    totals = dict.fromkeys(counters, 0)
    times, it = [], iter(trainer.train_loader)

    def adam_steps(p):
        return int(trainer.opt_main.state_of(p).get("step", 0))

    # step 1's splat coordinates (both phases), for the 0.95-mask check on
    # the step's own occupancy maps; the peak memory is read over steps
    # 2-4, without these copies
    splat_coords, splat = [], sampling.splat_mm

    def keep_coords(x, y, height, width):
        splat_coords.append((x.detach().clone(), y.detach().clone(), height, width))
        return splat(x, y, height, width)

    cp_times = []
    for step in range(1, steps + CP_STEPS + 1):
        cp = step > steps
        if step == 1:
            sampling.splat_mm = keep_coords
        batch = next(it)
        before = {k: p.detach().clone() for k, p in watch.items()}
        counts = {k: adam_steps(p) for k, p in watch.items()}
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with _env({"ENDODAV_WARP_CP": "1"} if cp else {}):
            scalars = trainer.train_one_batch(batch)
            loss, loss_0 = float(scalars["loss"]), float(scalars["loss_0"])  # waits for the step
        torch.cuda.synchronize(device)
        (cp_times if cp else times).append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters.items()}
        fused = counters["grid_sample_bwd_fused"]  # the step's one launch: the depth warps
        fit = f"{fused.last_tiles - fused.global_blocks()}/{fused.last_tiles}"
        changed = {k: not torch.equal(before[k], p.detach()) for k, p in watch.items()}
        # updated = Adam stepped the parameter: its gate was open and it got
        # a gradient (dvlora vectors at init get gradients near 1e-15, whose
        # first Adam step, lr * g / (|g| + 1e-8), is below their f32 ulp)
        updated = {k: adam_steps(p) == counts[k] + 1 for k, p in watch.items()}
        print(f"[train] step {step}{' ENDODAV_WARP_CP=1' if cp else ''}: loss {loss:.6f} "
              f"loss_0 {loss_0:.6f} {(cp_times if cp else times)[-1]:.1f} ms "
              f"launches {launches} changed {changed} updated {updated}; depth-warp tiles "
              f"summing d_img in shared memory {fit}")
        require(np.isfinite(loss) and np.isfinite(loss_0), f"step {step}: loss not finite")
        require(not changed["frozen"] and not updated["frozen"],
                f"step {step}: a frozen ViT weight changed")
        require(changed["pose"] and updated["pose"], f"step {step}: the pose decoder did not change")
        ab_phase = step <= 2  # --warm_up_step 2: LoRA A/B, then the dvlora vectors
        require(changed["lora_B"] == updated["lora_B"] == ab_phase,
                f"step {step}: LoRA B changed {changed['lora_B']}, expected {ab_phase}")
        require(updated["lora_U"] == (not ab_phase) and (ab_phase or not changed["lora_B"])
                and (not ab_phase or not changed["lora_U"]),
                f"step {step}: dvlora U updated {updated['lora_U']}, expected {not ab_phase}")
        expect = STEP_LAUNCHES_CP if cp else STEP_LAUNCHES
        require(launches == expect, f"step {step}: launches {launches}, expected {expect}")
        for k in totals:
            totals[k] += launches[k]
        if step == 1:
            sampling.splat_mm = splat
            agree = [splat_agreement(*c) for c in splat_coords]
            del splat_coords[:]
            print(f"[train] splat kernel vs plain on step 1's own coordinates: {agree}")
            for a in agree:
                require(a["rel_occ"] <= ATOMIC_RTOL and a["flips"] == 0,
                        f"splat on the step's coordinates: {a}")
            torch.cuda.reset_peak_memory_stats(device)
    peak = torch.cuda.max_memory_allocated(device)
    ms_step = statistics.median(times[1:])
    print(f"[train] {ms_step:.1f} ms/step (median of steps 2-{steps}), peak memory of steps "
          f"2-{steps + CP_STEPS} {peak / 2 ** 30:.2f} GiB ({card_line()})")
    if trace_dir:
        profile_step(trainer, next(it), trace_dir)
    it.close()
    print(f"[train] ENDODAV_WARP_CP=1 steps {steps + 1}-{steps + CP_STEPS}: "
          f"{[round(t, 1) for t in cp_times]} ms")
    return {"launches": totals, "ms_per_step": ms_step, "step_ms": times, "peak_bytes": peak,
            "splat": agree, "cp_step_ms": cp_times}


def check_dash_boundary(device, root):
    """A pair of small-configuration Dash steps across the phase boundary
    (`Trainer.dash_warmup` 2: step 1 trains LoRA A/B in phase 1, step 2
    first SVDs the frozen weights and trains ``lora_index``), on the card
    (kernels) and on the CPU (plain versions) from the same seed weights
    and loader batches.  Before step 2 the CPU trainer takes the card's
    weights, so that both SVD the same bits on the host.  Each step's
    losses within STEP_LOSS_RTOL, the gradient of a ViT block's LoRA B
    (step 1) and ``lora_index`` (step 2) within STEP_GRAD_RTOL of its
    largest entry; after step 2 both in phase 2, ``lora_index`` stepped by
    Adam, ``weight_u_top``/``weight_vt_top`` as the boundary left them (the
    CPU's, which no step touches) and never stepped."""
    from endodav_tpu_torch.train.trainer import Trainer

    args = ["--height", "64", "--width", "96", "--T", "4", "--depth_image_shape", "56", "70",
            "--lora_type", "dash"]
    gpu = own_policy("Trainer", Trainer, train_options(root, *args), device)
    cpu = own_policy("Trainer", Trainer, train_options(root, *args, "--no_cuda"))
    it = iter(cpu.train_loader)
    batches = [next(it), next(it)]
    it.close()
    name = "pretrained.blocks.5.mlp.fc1"
    errs = {}
    for step, batch in enumerate(batches, 1):
        if step == 2:
            for k, m in cpu.mods.items():
                m.load_state_dict(gpu.mods[k].state_dict())
        for t in (gpu, cpu):
            t.dash_warmup = 2
        got = gpu.train_one_batch(batch)
        with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's reduced-precision convs
            want = cpu.train_one_batch(batch)
        require(gpu.dash_phase2 == cpu.dash_phase2 == (step == 2),
                f"dash step {step}: phase 2 card {gpu.dash_phase2}, CPU {cpu.dash_phase2}")
        for k in ("loss_0", "loss"):
            a, b = float(got[k]), float(want[k])
            errs[f"step {step} {k}"] = abs(a - b) / abs(b)
            require(np.isfinite(a) and errs[f"step {step} {k}"] <= STEP_LOSS_RTOL,
                    f"dash step {step} {k}: card {a} vs CPU {b}")
        leaf = "lora_B" if step == 1 else "lora_index"
        pg = getattr(gpu.mods["depth_model"].get_submodule(name), leaf)
        pc = getattr(cpu.mods["depth_model"].get_submodule(name), leaf)
        require(pg.grad is not None and pc.grad is not None,
                f"dash step {step}: {name}.{leaf} got no gradient")
        err = (pg.grad.cpu() - pc.grad).abs().max().item() / pc.grad.abs().max().item()
        errs[f"step {step} grad {leaf}"] = err
        require(err <= STEP_GRAD_RTOL, f"dash step {step}: gradient of {leaf} relative err {err}")
    gl = gpu.mods["depth_model"].get_submodule(name)
    cl = cpu.mods["depth_model"].get_submodule(name)
    stepped = int(gpu.opt_main.state_of(gl.lora_index).get("step", 0))
    kept = (torch.equal(gl.weight_u_top.detach().cpu(), cl.weight_u_top.detach())
            and torch.equal(gl.weight_vt_top.detach().cpu(), cl.weight_vt_top.detach()))
    print(f"[dash boundary] card vs CPU, 64x96 T=4 ViT 56x70, steps 1-2 across the boundary: "
          f"errors {errs}; lora_index Adam steps {stepped}, |lora_index| "
          f"{gl.lora_index.detach().abs().max().item():.3e}, U/Vt as the boundary left them "
          f"{kept}")
    require(stepped == 1 and gl.lora_index.detach().abs().max().item() > 0,
            "dash: phase 2 did not train lora_index")
    require(kept and not gpu.opt_main.state_of(gl.weight_u_top)
            and not gpu.opt_main.state_of(gl.weight_vt_top),
            "dash: phase 2 moved weight_u_top / weight_vt_top")
    return errs


def run_ssb_training(device, root, steps=SSB_STEPS):
    """`scripts/train_video.sh`'s training exactly (`SSB_TRAIN_FLAGS`, ssb):
    `steps` steps of `train_one_batch` on the synthetic tree, each with
    finite losses, every kernel's launches (`STEP_LAUNCHES`), a frozen ViT
    weight unchanged, both ssb scale vectors of a ViT block's fc1 stepped
    by Adam, and a motion module's (the temporal group, off in steps
    1-399) not; ms of each step and the peak memory of steps 2 on."""
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    opt = EndoDAVOptions().parse([*SSB_TRAIN_FLAGS, "--data_path", root])
    trainer = own_policy("Trainer", Trainer, opt, device)
    params = dict(trainer.mods["depth_model"].named_parameters())
    motion_ff = "head.motion_modules.0.temporal_transformer.transformer_blocks.0.ff.net.2"
    watch = {"frozen": params["pretrained.blocks.0.attn.qkv.weight"],
             "lora_A": params["pretrained.blocks.5.mlp.fc1.lora_A"],
             "lora_B": params["pretrained.blocks.5.mlp.fc1.lora_B"],
             "temporal lora_B": params[f"{motion_ff}.lora_B"]}
    counters = _kernel_counters()
    totals = dict.fromkeys(counters, 0)
    times, it = [], iter(trainer.train_loader)
    for step in range(1, steps + 1):
        batch = next(it)
        before = {k: p.detach().clone() for k, p in watch.items()}
        counts = {k: int(trainer.opt_main.state_of(p).get("step", 0)) for k, p in watch.items()}
        for fn in counters.values():
            fn.launches = 0
        if step == 2:
            torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        scalars = trainer.train_one_batch(batch)
        loss, loss_0 = float(scalars["loss"]), float(scalars["loss_0"])  # waits for the step
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters.items()}
        updated = {k: int(trainer.opt_main.state_of(p).get("step", 0)) == counts[k] + 1
                   for k, p in watch.items()}
        changed = {k: not torch.equal(before[k], p.detach()) for k, p in watch.items()}
        print(f"[train ssb] step {step}: loss {loss:.6f} loss_0 {loss_0:.6f} {times[-1]:.1f} ms "
              f"launches {launches} changed {changed} updated {updated}")
        require(np.isfinite(loss) and np.isfinite(loss_0), f"ssb step {step}: loss not finite")
        require(not changed["frozen"] and not updated["frozen"],
                f"ssb step {step}: a frozen ViT weight changed")
        require(all(changed[k] and updated[k] for k in ("lora_A", "lora_B")),
                f"ssb step {step}: the spatial ssb vectors did not train")
        require(not changed["temporal lora_B"] and not updated["temporal lora_B"],
                f"ssb step {step}: a motion module's ssb vector trained in a spatial step")
        require(launches == STEP_LAUNCHES,
                f"ssb step {step}: launches {launches}, expected {STEP_LAUNCHES}")
        for k in totals:
            totals[k] += launches[k]
    it.close()
    peak = torch.cuda.max_memory_allocated(device)
    print(f"[train ssb] {' '.join(SSB_TRAIN_FLAGS)}: step ms {[round(t, 1) for t in times]}, "
          f"peak memory of steps 2-{steps} {peak / 2 ** 30:.2f} GiB ({card_line()})")
    return {"launches": totals, "step_ms": times, "peak_bytes": peak}


# the training script's tree: two sequences with ground truth (the val and
# test splits) and two without, 40 frames of 512x640 each; the training
# split of all four gives 7 clips of T=16
SCRIPT_SEQUENCES = (("train/dataset1/keyframe1", False), ("train/dataset2/keyframe1", False),
                    ("train/dataset5/keyframe1", True), ("train/dataset3/keyframe3", True))
SCRIPT_FRAMES = 40
# what one `Trainer.val` launches: the registration warp and the occlusion
# splat of the flow nets' forward, no backward
VAL_LAUNCHES = {"grid_sample_fwd": 1, "splat": 1}
SCRIPT_TAE_TOL = 1e-5  # the card's batched TAE/TAS against the CPU's, same depths


def write_script_tree(root, n_frames=SCRIPT_FRAMES, h=512, w=640):
    """A synthetic SCARED tree with ground truth, made with numpy from the
    seed: PNG left frames (a window drifting over a smooth texture), for
    the sequences marked so depths as 3-channel float TIFFs
    (``scene_points``) and camera poses (``frame_data`` JSON), and a split
    directory of its own (train: every sequence; val and test: those with
    ground truth).  Returns (data root, split directory)."""
    import cv2
    from PIL import Image

    rng = np.random.default_rng(SEED + 1)
    bh, bw = h + 3 * n_frames, w + 4 * n_frames
    yy, xx = np.meshgrid(np.linspace(0, bh / h, bh), np.linspace(0, bw / w, bw), indexing="ij")
    dy, dx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    data = os.path.join(root, "data")
    for name, gt in SCRIPT_SEQUENCES:
        base = os.path.join(data, name, "data")
        for sub in ("left", "scene_points", "frame_data") if gt else ("left",):
            os.makedirs(os.path.join(base, sub))
        phase = rng.uniform(0, 2 * np.pi, 3)
        tex = np.stack([128 + 70 * np.sin(9 * xx + 5 * yy + phase[c])
                        + 30 * np.cos(23 * yy - 17 * xx) for c in range(3)], -1)
        tex = np.clip(tex + rng.uniform(-12, 12, tex.shape), 0, 255).astype(np.uint8)
        for i in range(n_frames):
            Image.fromarray(tex[3 * i:3 * i + h, 4 * i:4 * i + w]).save(
                os.path.join(base, "left", f"{i:010d}.png"), compress_level=0)
            if gt:
                d = (40 + 30 * dy + 10 * np.cos(3 * dx + 0.03 * i)).astype(np.float32)
                cv2.imwrite(os.path.join(base, "scene_points", f"scene_points{i:06d}.tiff"),
                            np.stack([d, d, d], -1))
                pose = np.eye(4)
                pose[0, 3], pose[1, 3] = 0.4 * i, 0.3 * i
                with open(os.path.join(base, "frame_data", f"frame_data{i:06d}.json"), "w") as f:
                    json.dump({"camera-pose": pose.tolist()}, f)
    splits = os.path.join(root, "splits")
    os.makedirs(os.path.join(splits, "scared_video"))
    with_gt = [n for n, gt in SCRIPT_SEQUENCES if gt]
    for split, names in (("train", [n for n, _ in SCRIPT_SEQUENCES]), ("val", with_gt),
                         ("test", with_gt)):
        with open(os.path.join(splits, "scared_video", f"{split}_files.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return data, splits


def check_reload(label, trainer, folder, train_args):
    """``folder`` (a ``weights_last``) holds the eight components, the
    metadata and ``adam.msgpack``, and a fresh `Trainer` on the card at
    ``train_args`` loads every component of it bit for bit as ``trainer``
    holds it.  Returns the folder's bytes and the load's seconds."""
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    names = sorted(trainer.mods)
    files = sorted(os.listdir(folder))
    require(files == sorted([f"{n}.msgpack" for n in names]
                            + ["adam.msgpack", "depth_model.msgpack.meta.json"]),
            f"{label}: weights_last holds {files}")
    nbytes = sum(os.path.getsize(os.path.join(folder, f)) for f in files)
    t0 = time.perf_counter()
    fresh = own_policy("Trainer", Trainer, EndoDAVOptions().parse(
        [*train_args, "--load_weights_folder", folder, "--models_to_load", *names]))
    load_s = time.perf_counter() - t0
    for name in names:
        a, b = trainer.mods[name].state_dict(), fresh.mods[name].state_dict()
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        require(next(iter(b.values())).is_cuda and not differ,
                f"{label}: {name} loaded from weights_last differs in {differ[:4]}")
    return nbytes, load_s


@contextlib.contextmanager
def instrumented_trainer(device, watch=()):
    """`Trainer`'s `train_one_batch`, `val`, `run_epoch_eval` and `save_model`
    wrapped for the block: each step's losses and ms (synchronised), each
    val score and ms, the epoch evals' and the checkpoints' seconds; and,
    before the first step, copies of the depth model's parameters named in
    ``watch``.  Yields the record."""
    from endodav_tpu_torch.train.trainer import Trainer

    rec = {"steps": [], "vals": [], "val_ms": [], "evals": [], "saves": [], "before": {}}
    real = {k: getattr(Trainer, k)
            for k in ("train_one_batch", "val", "run_epoch_eval", "save_model")}

    def train_one_batch(self, batch):
        if not rec["steps"]:
            params = dict(self.mods["depth_model"].named_parameters())
            rec["before"] = {n: params[n].detach().clone() for n in watch}
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        scalars = real["train_one_batch"](self, batch)
        rec["steps"].append({"loss": float(scalars["loss"]),
                             "loss_0": float(scalars["loss_0"])})
        torch.cuda.synchronize(device)
        rec["steps"][-1]["ms"] = (time.perf_counter() - t) * 1e3
        return scalars

    def val(self):
        t = time.perf_counter()
        rec["vals"].append(real["val"](self))  # a float: the card has finished
        rec["val_ms"].append((time.perf_counter() - t) * 1e3)
        return rec["vals"][-1]

    def run_epoch_eval(self):
        t = time.perf_counter()
        out = real["run_epoch_eval"](self)
        rec["evals"].append(time.perf_counter() - t)
        return out

    def save_model(self, mode="epoch"):
        t = time.perf_counter()
        folder = real["save_model"](self, mode)
        rec["saves"].append(time.perf_counter() - t)
        return folder

    for k, fn in {"train_one_batch": train_one_batch, "val": val,
                  "run_epoch_eval": run_epoch_eval, "save_model": save_model}.items():
        setattr(Trainer, k, fn)
    try:
        yield rec
    finally:
        for k, fn in real.items():
            setattr(Trainer, k, fn)


def run_training_script(device, root):
    """`scripts/train_video.sh`'s two commands on the card: the training
    CLI's `main` with the script's flags exactly (`SCRIPT_TRAIN_FLAGS`) and
    one epoch, a log (scalars, panels and `val`) every 2 batches, then
    `cli/evaluate_depth_video_pose.evaluate` on ``weights_last`` with the
    eval command's flags.  Checks: every step's losses finite; each
    kernel's launches over the training run STEP_LAUNCHES a step,
    VAL_LAUNCHES a `val`, and the epoch eval's flash attention and
    temporal blocks (`expected_serving_launches`); ``weights_last`` holds
    the 8 components, the metadata and ``adam.msgpack``; a fresh `Trainer`
    on the card loads every component of it bit for bit as trained; the
    eval CLI's metrics finite and its launches as the epoch eval's; the
    card's `temporal_metrics_sequence` against the CPU's on the same
    depths.  Returns the launches and the times."""
    from endodav_tpu_torch.cli import evaluate_depth_video_pose
    from endodav_tpu_torch.data.scared import ScaredVideos
    from endodav_tpu_torch.eval.metrics_device import temporal_metrics_sequence
    from endodav_tpu_torch.options import EndoDAVOptions

    t0 = time.perf_counter()
    data, splits = write_script_tree(root)
    print(f"[training script] synthetic SCARED tree with ground truth written in "
          f"{time.perf_counter() - t0:.1f} s")
    log_dir = os.path.join(root, "log")
    n_seq = len([n for n, gt in SCRIPT_SEQUENCES if gt])
    trainer, folder, run = run_script_training(device, "training script", data, splits, n_seq,
                                               log_dir, SCRIPT_TRAIN_FLAGS, "endodav",
                                               min_steps=4)
    steps, val_ms, evals, saves = (run["record"][k] for k in ("steps", "val_ms", "evals",
                                                                "saves"))
    launches, serving, train_args = run["launches"], run["serving"], run["args"]
    train_s, peak = run["train_s"], run["peak_bytes"]
    counters = _kernel_counters()
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        results = open(os.path.join(log_dir, "endodav", "models", "results.txt")).read()
        print(f"[training script] results.txt: {results.strip()}")
        require(results.count("Epoch 01:") == 1, "training script: no results line")
        nbytes, load_s = check_reload("training script", trainer, folder, train_args)

        eval_opt = EndoDAVOptions().parse([*SCRIPT_EVAL_FLAGS, "--data_path", data,
                                           "--load_weights_folder", folder])
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = own_policy("build_depth_model", evaluate_depth_video_pose.evaluate, eval_opt)
        cli_s = time.perf_counter() - t0
        cli_launches = {k: fn.launches for k, fn in counters.items()}
        cli_expect = {k: serving.get(k, 0) for k in counters}
        require(cli_launches == cli_expect,
                f"eval CLI: launches {cli_launches}, expected {cli_expect}")
        depth = result["depth"]
        metrics = np.concatenate([depth["mean_errors"], depth["mean_temporal"]])
        pose = [(r["ate_mean"], r["re_mean"]) for r in result["pose"]]
        print(f"[training script] evaluate_depth_video_pose {' '.join(SCRIPT_EVAL_FLAGS)}: "
              f"depth and TAE/TAS {metrics.tolist()}, (ATE, RE) {pose}")
        require(np.isfinite(metrics).all() and np.isfinite(pose).all() and len(pose) == n_seq,
                "eval CLI: metrics not finite")

    seq = ScaredVideos(data, [SCRIPT_SEQUENCES[2][0]])[0]
    noise = np.random.default_rng(SEED).normal(0, 0.1, seq["depths"].shape)
    pred = (seq["depths"] * (1 + noise)).astype(np.float32)
    masks = (seq["depths"] > 1e-3) & (seq["depths"] < 150)
    i2l = np.stack([np.linalg.inv(k @ p) for k, p in zip(seq["Ks"], seq["poses"])])
    card = temporal_metrics_sequence(pred, masks, i2l, device=device)
    cpu = temporal_metrics_sequence(pred, masks, i2l)
    err = max(abs(a - b) for a, b in zip(card, cpu))
    print(f"[training script] temporal_metrics_sequence card {card} vs CPU {cpu}")
    require(err <= SCRIPT_TAE_TOL, f"TAE/TAS on the card differ from the CPU's by {err}")

    ms = statistics.median(s["ms"] for s in steps[1:])
    print(f"[training script] {ms:.1f} ms/step (median of steps 2-{len(steps)}), val "
          f"{statistics.median(val_ms):.1f} ms (median), training CLI {train_s:.1f} s with the "
          f"epoch eval {evals[0]:.1f} s and the checkpoints {[round(t, 2) for t in saves]} s "
          f"({nbytes / 2 ** 20:.1f} MiB a folder), a Trainer loading weights_last {load_s:.1f} s, "
          f"eval CLI {cli_s:.1f} s, peak memory {peak / 2 ** 30:.2f} GiB ({card_line()})")
    total = {k: launches[k] + cli_launches[k] for k in launches}
    return {"launches": total, "ms_per_step": ms, "step_ms": [s["ms"] for s in steps],
            "val_ms": val_ms, "train_s": train_s, "eval_s": evals[0], "save_s": saves,
            "folder_bytes": nbytes, "load_s": load_s, "cli_s": cli_s, "peak_bytes": peak,
            "tae_err": err}


# scripts/train_video_dac1.sh:9-12 and :14-16, the training and the eval
# command's flags exactly (EndoDAC vits with the trainer's default dvlora,
# no conv head, batch 16, T=1); --visualize_depth writes nothing in either
# command, as in JAX
DAC1_TRAIN_FLAGS = ["--model_type", "endodac", "--num_workers", "8", "--disable_conv_head",
                    "--batch_size", "16", "--T", "1", "--encoder", "vits", "--visualize_depth"]
DAC1_EVAL_FLAGS = ["--model_type", "endodac", "--eval_split", "scared_video", "--eval_mono",
                   "--visualize_depth"]
# the tree's sequences of 20 frames: the endovis train split of all four
# gives 77 clips of T=1, 4 batches of 16; the two with ground truth are the
# val and test sequences
DAC1_FRAMES = 20
# scripts/train_video_dac.sh:7-9: EndoDAC vitb, dvlora, batch 8 (its --T -1
# yields no clips; the phase trains at --T 1)
DAC_VITB_FLAGS = ["--model_type", "endodac", "--encoder", "vitb", "--batch_size", "8",
                  "--lora_type", "dvlora", "--warm_up_step", "20000"]
# launches a step with a single-frame depth model: the EndoDAV step's warps
# and splats; EndoDAC's ViT runs once on the batch's frames (a flash
# attention a block), no motion module; AF-SfM has no ViT
SINGLE_STEP_LAUNCHES = dict(STEP_LAUNCHES, fused_temporal_block=0)
AFSFM_STEP_LAUNCHES = dict(SINGLE_STEP_LAUNCHES, flash_attention=0)
DEPTH_STEPS, BF16_STEPS = 2, 5
# bf16 training's losses, the card against the CPU (a small step) and the
# warp kernels against their plain versions (a full-width step's forward):
# tests/test_torch_train_bf16.py's tolerance against JAX's bf16 losses.
# bf16 against f32 is not bounded by it: JAX's bf16 step builds its pixel
# grids in bf16, whose step is 2 px past x = 256, and its own bf16 loss
# moves 2.5e-2 (phase 0) and 5.5e-3 (main) from its f32 at 64x320
# (tools/bf16_train_gap.py); the card's gap is reported
BF16_LOSS_RTOL = 2e-3


def write_endovis_split(splits, train, val):
    """``<splits>/endovis/{train,val}_files.txt`` of whole sequences, the
    lines the video trainer reads (the repo's own endovis lists name single
    frames, which no video trainer can read)."""
    os.makedirs(os.path.join(splits, "endovis"), exist_ok=True)
    for name, seqs in (("train", train), ("val", val)):
        with open(os.path.join(splits, "endovis", f"{name}_files.txt"), "w") as f:
            f.write("\n".join(seqs) + "\n")


def window_eval_launches(model, sequences, chunk_windows):
    """The epoch eval's launches with a single-frame model on the window
    path (`Trainer.eval_forward`: the model on a chunk of windows, its
    frames flattened): one ViT forward, a flash attention a block, a chunk."""
    from endodav_tpu_torch.eval.video_inference import window_indices
    from endodav_tpu_torch.models.vit import VIT_CONFIGS

    chunks = sum(-(-len(window_indices(len(s["colors"]))) // chunk_windows) for s in sequences)
    return {"flash_attention": VIT_CONFIGS[model.backbone_size]["depth"] * chunks}


def run_dac1_script(device, root):
    """`scripts/train_video_dac1.sh`'s two commands on the card: the training
    CLI's `main` with the script's flags exactly (`DAC1_TRAIN_FLAGS`) for
    one epoch of 4 steps, a log (scalars, panels and `val`) every 2
    batches, on a synthetic tree with an ``endovis`` split of its own; then
    `cli/evaluate_depth_video_pose.evaluate` on ``weights_last`` with the
    eval command's flags.  Checks: every step's losses finite; each kernel's
    launches (SINGLE_STEP_LAUNCHES a step, VAL_LAUNCHES a `val`, the epoch
    eval's flash attentions on the window path); the LoRA A and B of a ViT
    block (``spatial_ab``) stepped by Adam every step and B moved, a frozen
    ViT weight neither; a fresh
    `Trainer` loads every component of ``weights_last`` bit for bit; the
    eval command's flags refuse ``weights_last`` (they build the conv head
    the training left out, as JAX's do), and with ``--disable_conv_head``
    added the eval CLI's metrics are finite and its launches those of
    single-frame batches.  Returns the launches and the times."""
    from endodav_tpu_torch.cli import evaluate_depth_video_pose, train_end_to_end_video
    from endodav_tpu_torch.options import EndoDAVOptions

    t0 = time.perf_counter()
    data, splits = write_script_tree(root, n_frames=DAC1_FRAMES)
    with_gt = [n for n, gt in SCRIPT_SEQUENCES if gt]
    write_endovis_split(splits, [n for n, _ in SCRIPT_SEQUENCES], with_gt)
    print(f"[train_video_dac1.sh] synthetic tree written in {time.perf_counter() - t0:.1f} s")
    log_dir = os.path.join(root, "log")
    counters = _kernel_counters()
    train_args = [*DAC1_TRAIN_FLAGS, "--data_path", data, "--log_dir", log_dir,
                  "--num_epochs", "1", "--log_frequency", "2"]
    watch = ("pretrained.blocks.5.mlp.fc1.lora_A", "pretrained.blocks.5.mlp.fc1.lora_B",
             "pretrained.blocks.0.attn.qkv.weight")
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        with instrumented_trainer(device, watch) as rec:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            trainer = own_policy("train_end_to_end_video", train_end_to_end_video.main,
                                 train_args)
            train_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(device)
        steps, vals = rec["steps"], rec["vals"]
        print(f"[train_video_dac1.sh] train_end_to_end_video {' '.join(train_args)}: "
              f"{len(steps)} steps, losses {[(round(s['loss'], 6), round(s['loss_0'], 6)) for s in steps]}, "
              f"step ms {[round(s['ms'], 1) for s in steps]}, val scores {vals}, launches "
              f"{launches}")
        require(len(steps) == len(trainer.train_loader) == 4,
                f"train_video_dac1.sh: {len(steps)} steps, expected the epoch's 4")
        require(all(np.isfinite([s["loss"], s["loss_0"]]).all() for s in steps),
                "train_video_dac1.sh: a step's loss is not finite")
        require(len(vals) == 2 and np.isfinite(vals).all(), f"train_video_dac1.sh: val {vals}")
        n_seq = len(with_gt)
        serving = window_eval_launches(trainer.mods["depth_model"],
                                       [{"colors": range(DAC1_FRAMES)}] * n_seq,
                                       trainer.opt.chunk_windows)
        expect = {k: n * len(steps) + VAL_LAUNCHES.get(k, 0) * len(vals) + serving.get(k, 0)
                  for k, n in SINGLE_STEP_LAUNCHES.items()}
        require(launches == expect, f"train_video_dac1.sh: launches {launches}, expected {expect}")
        # the spatial_ab group trained every step: Adam stepped the LoRA A and
        # B each time, and B moved (A's gradient is B's size, ~1e-16 at the
        # zero-initialised B, so A's first steps fall below its f32 ulp); the
        # frozen weight neither stepped nor moved
        params = dict(trainer.mods["depth_model"].named_parameters())
        moved = {n: not torch.equal(rec["before"][n], params[n].detach()) for n in watch}
        stepped = {n: int(trainer.opt_main.state_of(params[n]).get("step", 0)) for n in watch}
        print(f"[train_video_dac1.sh] over the epoch: moved {moved}, Adam steps {stepped}")
        require(stepped[watch[0]] == stepped[watch[1]] == len(steps) and moved[watch[1]]
                and not stepped[watch[2]] and not moved[watch[2]],
                f"train_video_dac1.sh: LoRA A/B should step and the frozen weight not: "
                f"moved {moved}, stepped {stepped}")

        folder = os.path.join(log_dir, "endodac", "models", "weights_last")
        check_reload("train_video_dac1.sh", trainer, folder, train_args)

        # the script's eval command builds EndoDAC with the conv head its
        # training left out, and the folder has no conv_depth weights: the
        # load refuses it, as flax's does in JAX; the model it trained
        # serves with --disable_conv_head added
        exact = EndoDAVOptions().parse([*DAC1_EVAL_FLAGS, "--data_path", data,
                                        "--load_weights_folder", folder])
        try:
            evaluate_depth_video_pose.evaluate(exact)
        except ValueError as e:
            require("conv_depth_1" in str(e), f"train_video_dac1.sh eval command: {e}")
            print(f"[train_video_dac1.sh] the script's eval flags refuse weights_last, as "
                  f"JAX's: {e}")
        else:
            require(False, "train_video_dac1.sh eval command: loaded a folder without "
                           "conv_depth weights into a conv head")
        eval_opt = EndoDAVOptions().parse([*DAC1_EVAL_FLAGS, "--disable_conv_head",
                                           "--data_path", data, "--load_weights_folder", folder])
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = own_policy("build_depth_model", evaluate_depth_video_pose.evaluate, eval_opt)
        cli_s = time.perf_counter() - t0
        cli_launches = {k: fn.launches for k, fn in counters.items()}
        cli_serving, _ = expected_serving_launches(
            eval_opt, types.SimpleNamespace(model=trainer.mods["depth_model"]),
            [{"colors": range(DAC1_FRAMES)}] * n_seq)
        cli_expect = {k: cli_serving.get(k, 0) for k in counters}
        require(cli_launches == cli_expect,
                f"train_video_dac1.sh eval CLI: launches {cli_launches}, expected {cli_expect}")
        depth = result["depth"]
        metrics = np.concatenate([depth["mean_errors"], depth["mean_temporal"]])
        pose = [(r["ate_mean"], r["re_mean"]) for r in result["pose"]]
        print(f"[train_video_dac1.sh] evaluate_depth_video_pose {' '.join(DAC1_EVAL_FLAGS)}: "
              f"depth and TAE/TAS {metrics.tolist()}, (ATE, RE) {pose}")
        require(np.isfinite(metrics).all() and np.isfinite(pose).all() and len(pose) == n_seq,
                "train_video_dac1.sh eval CLI: metrics not finite")
    ms = statistics.median(s["ms"] for s in steps[1:])
    print(f"[train_video_dac1.sh] {ms:.1f} ms/step (median of steps 2-{len(steps)}), training "
          f"CLI {train_s:.1f} s with the epoch eval {rec['evals'][0]:.1f} s, eval CLI "
          f"{cli_s:.1f} s, peak memory {peak / 2 ** 30:.2f} GiB ({card_line()})")
    total = {k: launches[k] + cli_launches[k] for k in launches}
    return {"launches": total, "ms_per_step": ms, "step_ms": [s["ms"] for s in steps],
            "train_s": train_s, "eval_s": rec["evals"][0], "cli_s": cli_s, "peak_bytes": peak}


def train_steps(device, trainer, label, batches, expect, watch=(), peak_from=2):
    """`train_one_batch` on each of ``batches``, timed (synchronised): finite
    losses and every kernel's launches ``expect`` a step; the depth model's
    state entries named in ``watch`` before and after.  Returns the losses,
    ms, launches, the peak memory from step ``peak_from`` on and whether
    each watched entry moved."""
    counters = _kernel_counters()
    totals = dict.fromkeys(counters, 0)
    state = trainer.mods["depth_model"].state_dict()
    before = {n: state[n].detach().clone() for n in watch}
    losses, times = [], []
    for step, batch in enumerate(batches, 1):
        for fn in counters.values():
            fn.launches = 0
        if step == peak_from:
            torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        scalars = trainer.train_one_batch(batch)
        losses.append((float(scalars["loss"]), float(scalars["loss_0"])))  # waits for the step
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"[{label}] step {step}: loss {losses[-1][0]:.6f} loss_0 {losses[-1][1]:.6f} "
              f"{times[-1]:.1f} ms launches {launches}")
        require(np.isfinite(losses[-1]).all(), f"{label} step {step}: loss not finite")
        require(launches == expect, f"{label} step {step}: launches {launches}, expected {expect}")
        for k in totals:
            totals[k] += launches[k]
    peak = torch.cuda.max_memory_allocated(device)
    state = trainer.mods["depth_model"].state_dict()
    moved = {n: not torch.equal(before[n], state[n]) for n in watch}
    return {"losses": losses, "step_ms": times, "launches": totals, "peak_bytes": peak,
            "moved": moved}


def depth_trainer(device, root, splits, flags, *extra):
    """A full-width `Trainer` on the card over the synthetic tree, reading
    the split directory ``splits``, and its first batches."""
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    opt = EndoDAVOptions().parse([*flags, "--data_path", root, "--num_workers", "2",
                                  "--seed", str(SEED), *extra])
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        return own_policy("Trainer", Trainer, opt, device)


def first_batches(trainer, n):
    it = iter(trainer.train_loader)
    batches = [next(it) for _ in range(n)]
    it.close()
    return batches


def run_single_frame_training(device, root, splits):
    """The other depth models at full width (256x320) on the synthetic tree
    read through an ``endovis`` split: `scripts/train_video_dac.sh`'s model
    (EndoDAC vitb, dvlora, batch 8), whose own ``--T -1`` must raise JAX's
    error, for DEPTH_STEPS steps at --T 1 (LoRA B moves, a frozen weight
    not); AF-SfM (batch 8, T=1) for DEPTH_STEPS steps, whose depth
    weights and running statistics must not move (every one ``frozen``;
    JAX drops the BatchNorm statistics of the depth model); and each in
    bf16 for DEPTH_STEPS steps.  Returns launches and times."""
    out, launches = {}, None
    try:
        depth_trainer(device, root, splits, [*DAC_VITB_FLAGS, "--T", "-1"])
    except ValueError as e:
        require("the default -1 yields no clips" in str(e),
                f"train_video_dac.sh --T -1: raised {e}")
        print(f"[train vitb] train_video_dac.sh's --T -1 raises, as JAX: {e}")
    else:
        require(False, "train_video_dac.sh --T -1: no error")
    watch_dac = ("pretrained.blocks.5.mlp.fc1.lora_B", "pretrained.blocks.0.attn.qkv.weight")
    afsfm = ["--model_type", "afsfm", "--batch_size", "8"]
    for label, flags, expect, dtype in (
            ("train vitb", DAC_VITB_FLAGS, SINGLE_STEP_LAUNCHES, "float32"),
            ("train vitb bf16", DAC_VITB_FLAGS, SINGLE_STEP_LAUNCHES, "bfloat16"),
            ("train afsfm", afsfm, AFSFM_STEP_LAUNCHES, "float32"),
            ("train afsfm bf16", afsfm, AFSFM_STEP_LAUNCHES, "bfloat16")):
        trainer = depth_trainer(device, root, splits, flags, "--T", "1",
                                "--compute_dtype", dtype)
        model = trainer.mods["depth_model"]
        watch = (watch_dac if model.model_type == "endodac"
                 else tuple(model.state_dict()))  # AF-SfM: every weight and statistic
        r = train_steps(device, trainer, label, first_batches(trainer, DEPTH_STEPS), expect,
                        watch)
        if model.model_type == "endodac":
            require(r["moved"][watch[0]] and not r["moved"][watch[1]],
                    f"{label}: LoRA B should move and the frozen weight not: {r['moved']}")
        else:
            moved = [n for n, m in r["moved"].items() if m]
            require(not moved, f"{label}: AF-SfM depth state moved: {moved[:4]}")
            require(all(p.grad is None for p in model.parameters()),
                    f"{label}: an AF-SfM depth weight got a gradient")
        print(f"[{label}] {' '.join(flags)} --T 1 --compute_dtype {dtype}: step ms "
              f"{[round(t, 1) for t in r['step_ms']]}, peak memory of steps 2-{DEPTH_STEPS} "
              f"{r['peak_bytes'] / 2 ** 30:.2f} GiB ({card_line()})")
        launches = r["launches"] if launches is None else {
            k: launches[k] + n for k, n in r["launches"].items()}
        out[label] = r
        del trainer
    return out, launches


def step_losses(trainer, batch):
    """Step 1's two losses of ``trainer`` on the device batch ``batch``
    without a backward or an update: phase 0 and the main phase, the
    BatchNorm statistics they record dropped."""
    from endodav_tpu_torch.models.resnet import discard_batch_stats
    from endodav_tpu_torch.train import losses as L
    from endodav_tpu_torch.train import optim as O

    cfg = trainer.loss_cfg
    scales, hw = cfg["scales"], (cfg["height"], cfg["width"])
    gates = O.schedule_gates(trainer.step, trainer.sched_cfg, trainer.dash_phase2)
    with torch.no_grad():
        out = L.forward_flow_nets(trainer.mods, batch, scales, hw, train_position=True,
                                  train_transform=False)
        loss_0 = float(L.position_phase_loss(out, batch, scales, cfg["position_smoothness"],
                                             not cfg["no_ssim"]))
        loss = float(L.main_phase(trainer.mods, batch, cfg,
                                  temporal_weight=gates["tune_temporal"])[0])
    for m in trainer.mods.values():
        discard_batch_stats(m)
    return loss_0, loss


def run_bf16_training(device, root):
    """`scripts/train_video.sh`'s training (ssb) with ``--compute_dtype
    bfloat16`` beside float32 on the same seed weights and the same
    BF16_STEPS batches: step 1's losses with the warp kernels against the
    plain versions (ENDODAV_NO_WARP_MM=1) on the same bf16 inputs, within
    BF16_LOSS_RTOL; every kernel's launches (STEP_LAUNCHES) each step, the
    flash attentions and temporal blocks on bf16 tensors; ms/step
    (steps 2 on) and peak memory of each, and step 1's bf16 losses against
    the f32 ones (reported: see BF16_LOSS_RTOL)."""
    from endodav_tpu_torch.eval.engine import splits_dir
    from endodav_tpu_torch.kernels import flash_attention
    from endodav_tpu_torch.kernels import fused_temporal_block as ftb

    legs = {}
    batches = None
    for dtype in ("float32", "bfloat16"):
        trainer = depth_trainer(device, root, splits_dir(), SSB_TRAIN_FLAGS,
                                "--compute_dtype", dtype)
        if batches is None:
            batches = first_batches(trainer, BF16_STEPS)
        first = trainer.device_batch(batches[0])
        kernels = step_losses(trainer, first)
        with _env({"ENDODAV_NO_WARP_MM": "1"}):
            plain = step_losses(trainer, first)
        rel = [abs(a - b) / abs(b) for a, b in zip(kernels, plain)]
        print(f"[train ssb {dtype}] step 1's (loss_0, loss) with the warp kernels {kernels}, "
              f"with their plain versions {plain}: relative {rel}")
        require(max(rel) <= (BF16_LOSS_RTOL if dtype == "bfloat16" else STEP_LOSS_RTOL),
                f"train ssb {dtype}: the warp kernels move step 1's losses by {rel}")
        del first
        seen = []
        real = {m: m._launch for m in (flash_attention, ftb)}
        for m, fn in real.items():
            m._launch = lambda *a, fn=fn: seen.append(a[0].dtype) or fn(*a)
        try:
            legs[dtype] = train_steps(device, trainer, f"train ssb {dtype}", batches,
                                      STEP_LAUNCHES)
        finally:
            for m, fn in real.items():
                m._launch = fn
        want = torch.float32 if dtype == "float32" else torch.bfloat16
        require(seen and set(seen) == {want},
                f"train ssb {dtype}: attention kernels launched on {set(seen)}")
        legs[dtype]["ms_per_step"] = statistics.median(legs[dtype]["step_ms"][1:])
        legs[dtype]["warps_vs_plain"] = rel
        del trainer
    (l32, l032), (l16, l016) = legs["float32"]["losses"][0], legs["bfloat16"]["losses"][0]
    rel = (abs(l16 - l32) / abs(l32), abs(l016 - l032) / abs(l032))
    print(f"[train bf16] {' '.join(SSB_TRAIN_FLAGS)}: step 1 on the same weights and batch, "
          f"loss f32 {l32:.6f} bf16 {l16:.6f}, loss_0 f32 {l032:.6f} bf16 {l016:.6f}, relative "
          f"{rel}; ms/step (median of steps 2-{BF16_STEPS}) f32 "
          f"{legs['float32']['ms_per_step']:.1f} bf16 {legs['bfloat16']['ms_per_step']:.1f}; "
          f"peak memory f32 {legs['float32']['peak_bytes'] / 2 ** 30:.2f} GiB bf16 "
          f"{legs['bfloat16']['peak_bytes'] / 2 ** 30:.2f} GiB ({card_line()})")
    legs["rel"] = rel
    return legs


def run_rope_training(device, root):
    """`scripts/train_video.sh`'s training (ssb) with a RoPE EndoDAV (no
    flag builds one, as in JAX: `train/trainer.py:build_models` made to
    build ``EndoDAV(pos_embedding_type="rope")``) for ROPE_STEPS steps in
    f32 and in bf16: RoPE keeps the unfused route in training, two
    temporal attentions a motion module (ROPE_STEP_LAUNCHES), on tensors
    of the step's dtype.  Returns the launches and the times of each."""
    import functools

    from endodav_tpu_torch.eval.engine import splits_dir
    from endodav_tpu_torch.kernels import temporal_attention
    from endodav_tpu_torch.train import trainer as T

    legs = {}
    for dtype in ("float32", "bfloat16"):
        real_model = T.EndoDAV
        T.EndoDAV = functools.partial(real_model, pos_embedding_type="rope")
        try:
            trainer = depth_trainer(device, root, splits_dir(), SSB_TRAIN_FLAGS,
                                    "--compute_dtype", dtype)
        finally:
            T.EndoDAV = real_model
        require(trainer.mods["depth_model"].config["pos_embedding_type"] == "rope",
                "rope training: the depth model is not RoPE")
        seen, real = [], temporal_attention._launch
        temporal_attention._launch = lambda *a: seen.append(a[0].dtype) or real(*a)
        try:
            legs[dtype] = train_steps(device, trainer, f"train ssb rope {dtype}",
                                      first_batches(trainer, ROPE_STEPS), ROPE_STEP_LAUNCHES)
        finally:
            temporal_attention._launch = real
        want = torch.float32 if dtype == "float32" else torch.bfloat16
        require(seen and set(seen) == {want},
                f"rope training {dtype}: temporal attention launched on {set(seen)}")
        print(f"[train ssb rope {dtype}] step ms {[round(t, 1) for t in legs[dtype]['step_ms']]}, "
              f"peak memory {legs[dtype]['peak_bytes'] / 2 ** 30:.2f} GiB ({card_line()})")
        del trainer
    return legs


# scripts/eval_depth_video1.sh's command exactly (the model that
# scripts/train_video.sh trains), and eval_depth_video_hamlyn_npy.sh's
HAMLYN_EVAL_FLAGS = ["--model_type", "endodav", "--eval_split", "hamlyn_video",
                     "--eval_mono", "--visualize_depth", "--disable_residual_block",
                     "--disable_conv_head", "--lora_type=ssb"]
HAMLYN_NPY_FLAGS = ["--eval_split", "hamlyn_video"]
HAMLYN_SEQS, HAMLYN_FRAMES, HAMLYN_HW, HAMLYN_MAX_LENGTH = 2, 64, (288, 360), 32
# the --pred_root re-score of the model run's saved (aligned) depths
# against the model run: the refit of aligned depths is the identity up to
# rounding (their median and mean deviation are the ground truth's), and
# the files are read back in f32 (`HamlynVideos`, as JAX's), which moves
# a depth by 6e-8 relative; a pixel whose ratio to the ground truth then
# crosses a threshold of a1-a3 moves its frame's share by 1 / (288 * 360)
# = 1e-5: 1e-4 relative
HAMLYN_RESCORE_RTOL = 1e-4


def write_hamlyn_tree(root, n_seq=HAMLYN_SEQS, n_frames=HAMLYN_FRAMES, hw=HAMLYN_HW):
    """A synthetic Hamlyn tree made with numpy from the seed: ``rectifiedNN``
    sequences of ``image01/*.jpg`` frames (PIL) and 16-bit
    ``depth01/*.png`` depths, a few rows invalid as at a rectified border,
    and a split directory whose ``hamlyn_video/val_files_all.txt`` names
    them.  Returns (data root, split directory, sequence names)."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 3)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    names = [f"rectified{k + 1:02d}" for k in range(n_seq)]
    data = os.path.join(root, "hamlyn")
    for name in names:
        base = os.path.join(data, name)
        os.makedirs(os.path.join(base, "image01"))
        os.makedirs(os.path.join(base, "depth01"))
        phase = rng.uniform(0, 2 * np.pi, 3)
        for i in range(n_frames):
            img = np.stack([128 + 90 * np.sin(7 * xx + 5 * yy + 0.06 * i + phase[c])
                            for c in range(3)], -1) + rng.uniform(-10, 10, (h, w, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(base, "image01", f"{i:010d}.jpg"), quality=95)
            d = 60 + 40 * yy + 15 * np.cos(3 * xx + 0.05 * i)
            d[:4] = 0
            Image.fromarray(d.astype(np.uint16)).save(
                os.path.join(base, "depth01", f"{i:010d}.png"))
    splits = os.path.join(root, "splits_hamlyn")
    os.makedirs(os.path.join(splits, "hamlyn_video"))
    with open(os.path.join(splits, "hamlyn_video", "val_files_all.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return data, splits, names


@contextlib.contextmanager
def captured_stdout():
    """The block's standard output, kept (``.getvalue()``) and printed after."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        sys.stdout.write(buf.getvalue())


def run_cli(label, run, opt, n_frames):
    """``run()``, a CLI on ``opt``, with the serving kernels' counts set to
    0 just before and read just after: the launches
    `expected_serving_launches` gives for sequences of ``n_frames`` frames.
    Returns the CLI's result, its standard output, its seconds and the
    launches."""
    from endodav_tpu_torch.eval import engine

    counters = _serving_counters()
    made, real = [], engine.depth_window_forward
    engine.depth_window_forward = lambda model: made.append(real(model)) or made[-1]
    for fn in counters.values():
        fn.launches = 0
    try:
        t = time.perf_counter()
        with captured_stdout() as out:
            result = own_policy(label, run)
        seconds = time.perf_counter() - t
    finally:
        engine.depth_window_forward = real
    launches = {k: fn.launches for k, fn in counters.items()}
    expect, _ = expected_serving_launches(opt, made[-1], [{"colors": range(n)} for n in n_frames])
    require(launches == expect, f"{label}: launches {launches}, expected {expect}")
    return result, out.getvalue(), seconds, launches


def run_hamlyn_script(device, root, weights):
    """`scripts/eval_depth_video1.sh`'s command on the card
    (`cli/evaluate_depth_video_hamlyn`, `HAMLYN_EVAL_FLAGS`) on the
    ``weights`` folder over a synthetic Hamlyn tree: finite metrics, the
    launches of rows 1 and 2/3 those of the window path over the tree's
    frames (`expected_serving_launches`), and each sequence's vis.mp4 (or
    JAX's "mp4 export failed" line) and its aligned depth .npy files; then
    `scripts/eval_depth_video_hamlyn_npy.sh`'s (``--pred_root`` on those
    files: no launch, the seven metrics within HAMLYN_RESCORE_RTOL of the
    model run's), and the model run with ``--max_length 32`` (32 frames a
    sequence, its launches).  Returns the launches and the times."""
    from endodav_tpu_torch.cli import evaluate_depth_video_hamlyn as cli
    from endodav_tpu_torch.options import EndoDAVOptions

    t0 = time.perf_counter()
    data, splits, names = write_hamlyn_tree(root)
    print(f"[hamlyn] synthetic Hamlyn tree ({len(names)} x {HAMLYN_FRAMES} frames of "
          f"{HAMLYN_HW[0]}x{HAMLYN_HW[1]}) written in {time.perf_counter() - t0:.1f} s")
    counters = _serving_counters()
    totals = dict.fromkeys(counters, 0)

    def model_run(args, n_frames):
        result, out, seconds, launches = run_cli(
            "evaluate_depth_video_hamlyn", lambda: cli.main(args), EndoDAVOptions().parse(args),
            [n_frames] * len(names))
        require(np.isfinite(result["mean_errors"]).all() and result["mean_temporal"] is None,
                f"hamlyn {args}: metrics {result['mean_errors']}")
        require(result["all_errors"].shape == (len(names) * n_frames, 7),
                f"hamlyn {args}: {result['all_errors'].shape[0]} frames scored, expected "
                f"{len(names) * n_frames}")
        for k in totals:
            totals[k] += launches[k]
        return result, out, seconds, launches

    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        args = [*HAMLYN_EVAL_FLAGS, "--data_path", data, "--load_weights_folder", weights]
        result, out, cli_s, launches = model_run(args, HAMLYN_FRAMES)
        saved = os.path.join(weights, "eval", "hamlyn_video")
        for name in names:
            npys = sorted(os.listdir(os.path.join(saved, name, "depth")))
            require(npys == [f"{i:06d}.npy" for i in range(HAMLYN_FRAMES)],
                    f"hamlyn: {name} saved {len(npys)} depth files")
            mp4 = os.path.exists(os.path.join(saved, name, "vis.mp4"))
            require(mp4 or "[eval] mp4 export failed" in out, f"hamlyn: {name} has no vis.mp4")
        print(f"[hamlyn] evaluate_depth_video_hamlyn {' '.join(HAMLYN_EVAL_FLAGS)}: metrics "
              f"{result['mean_errors'].tolist()}, launches {launches}, "
              f"{result['mean_infer_ms']:.3f} ms/frame, the CLI {cli_s:.1f} s, vis.mp4 "
              f"{'written' if mp4 else 'not written (the mp4 writer failed, as JAX reports)'}")

        npy_args = ["--data_path", data, *HAMLYN_NPY_FLAGS, "--pred_root", saved]
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        rescore = cli.main(npy_args)
        rescore_s = time.perf_counter() - t
        rel = np.abs(rescore["mean_errors"] - result["mean_errors"]) / np.abs(result["mean_errors"])
        print(f"[hamlyn] evaluate_depth_video_hamlyn {' '.join(HAMLYN_NPY_FLAGS)} --pred_root: "
              f"metrics {rescore['mean_errors'].tolist()}, relative to the model run "
              f"{rel.tolist()}, {rescore_s:.1f} s")
        require(not any(fn.launches for fn in counters.values()),
                "hamlyn --pred_root launched a kernel")
        require(rescore["all_errors"].shape == result["all_errors"].shape
                and float(rel.max()) <= HAMLYN_RESCORE_RTOL,
                f"hamlyn --pred_root: metrics relative {rel} to the model run's")

        short, _, short_s, _ = model_run(
            [*[a for a in args if a != "--visualize_depth"], "--max_length",
             str(HAMLYN_MAX_LENGTH)], HAMLYN_MAX_LENGTH)
        print(f"[hamlyn] --max_length {HAMLYN_MAX_LENGTH}: metrics "
              f"{short['mean_errors'].tolist()}, {short['mean_infer_ms']:.3f} ms/frame, "
              f"{short_s:.1f} s ({card_line()})")
    return {"launches": totals, "ms_per_frame": result["mean_infer_ms"], "cli_s": cli_s,
            "rescore_s": rescore_s, "rescore_rel": float(rel.max()), "saved": saved,
            "data": data, "names": names, "max_length_s": short_s}


def write_pose_split(splits, sequences, n_frames):
    """``<splits>/endovis``: the pose lists of `cli/evaluate_pose` and
    `cli/export_gt` (``test_files_sequence{1,2}.txt``, frames 1 to
    n_frames - 2 of each named sequence, in the repo's line format
    ``dataset5/keyframe1<TAB>frame<TAB>l``) and ``test_files.txt`` for the
    depth export.  ``sequences`` are the tree's ``train/...`` names."""
    os.makedirs(os.path.join(splits, "endovis"), exist_ok=True)
    folders = [name.split("/", 1)[1] for name in sequences]
    for n, folder in enumerate(folders, start=1):
        with open(os.path.join(splits, "endovis", f"test_files_sequence{n}.txt"), "w") as f:
            f.write("".join(f"{folder}\t{i}\tl\n" for i in range(1, n_frames - 1)))
    with open(os.path.join(splits, "endovis", "test_files.txt"), "w") as f:
        f.write("".join(f"{folder}\t{i}\tl\n" for folder in folders
                        for i in range(1, n_frames, 8)))
    return len(folders) * (n_frames - 2)


def run_pose_tools(device, data, splits, weights, hamlyn):
    """`scripts/export_gt.sh` (`cli/export_gt --what both`) into the split
    directory ``splits`` over the SCARED tree ``data`` (the training
    script's, with ``frame_data`` poses and ``scene_points`` TIFFs), then
    `scripts/eval_pose.sh` (`cli/evaluate_pose --eval_mono`) on the pose
    encoder, pose decoder and intrinsics head of ``weights`` on the card,
    then `cli/visualize --mode pose` on the npz files it wrote and
    ``--mode reconstruction`` on the Hamlyn run's saved depths (``hamlyn``:
    its result; the sequence's frames under a SCARED-layout view).  Checks
    the files and finite ATE, RE and intrinsics.  Returns the times."""
    from endodav_tpu_torch.cli import evaluate_pose, export_gt, visualize

    with_gt = [n for n, gt in SCRIPT_SEQUENCES if gt]
    n_pairs = write_pose_split(splits, with_gt, SCRIPT_FRAMES)
    curve = os.path.join(splits, "endovis", "curve")
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        t = time.perf_counter()
        export_gt.main(["--data_path", data, "--what", "both"])
        export_s = time.perf_counter() - t
        gt_depths = np.load(os.path.join(splits, "endovis", "gt_depths.npz"))["data"]
        gt_poses = [np.load(os.path.join(curve, f"gt_poses_sequence{n}.npz"))["data"]
                    for n in (1, 2)]
        require(gt_depths.ndim == 3 and np.isfinite(gt_depths).all()
                and all(p.shape == (SCRIPT_FRAMES - 2, 4, 4) for p in gt_poses),
                f"export_gt: depths {gt_depths.shape}, poses {[p.shape for p in gt_poses]}")
        t = time.perf_counter()
        with captured_stdout() as out:
            results = own_policy("evaluate_pose", evaluate_pose.main,
                                 ["--data_path", data, "--load_weights_folder", weights,
                                  "--eval_mono"])
        pose_s = time.perf_counter() - t
    report = [ln for ln in out.getvalue().splitlines()
              if ln.startswith(("sq", "fx", "fy", "cx", "cy"))]
    require(sorted(results) == [1, 2] and all(
        np.isfinite([r["ate_mean"], r["re_mean"], *r["ate_ci"]]).all() for r in results.values())
        and len(report) == 8, f"evaluate_pose: {report}")
    require(os.path.exists(os.path.join(weights, "pose_eval.txt")),
            "evaluate_pose: no pose_eval.txt")
    print(f"[pose tools] export_gt --what both {export_s:.1f} s (depths {gt_depths.shape}); "
          f"evaluate_pose --eval_mono {pose_s:.1f} s, {pose_s / n_pairs * 1e3:.2f} ms/pair over "
          f"{n_pairs} pairs with the nets' build: {report}")
    out_dir = os.path.join(os.path.dirname(splits), "vis")
    plot = os.path.join(out_dir, "trajectory_sequence1.png")
    os.makedirs(out_dir)
    npz = [np.load(os.path.join(curve, f"{k}_poses_sequence1.npz"))["data"] for k in ("pred", "gt")]
    t = time.perf_counter()
    try:
        visualize.main(["--mode", "pose", "--pred_poses",
                        os.path.join(curve, "pred_poses_sequence1.npz"),
                        "--gt_poses", os.path.join(curve, "gt_poses_sequence1.npz"), "--out", plot])
        drawn = "drawn"
        require(os.path.getsize(plot) > 0, "visualize --mode pose: no plot")
    except ModuleNotFoundError as e:
        # the plot is matplotlib's, as JAX's; the card machine has none
        require(e.name == "matplotlib", f"visualize --mode pose: {e}")
        drawn = "not drawn: matplotlib is absent here, and the plot is matplotlib's, as JAX's"
    pts = visualize.trajectory_points(*npz)
    plot_s = time.perf_counter() - t
    # the origin and one point a pose
    require(all(p.shape == (SCRIPT_FRAMES - 1, 3) and np.isfinite(p).all() for p in pts),
            f"visualize --mode pose: trajectory points {[p.shape for p in pts]}")
    # the Hamlyn frames of a sequence under a SCARED-layout view
    # (<seq>/data/left), beside the run's saved depths
    view = os.path.join(os.path.dirname(splits), "hamlyn_view")
    name = hamlyn["names"][0]
    os.makedirs(os.path.join(view, name, "data"))
    os.symlink(os.path.join(hamlyn["data"], name, "image01"),
               os.path.join(view, name, "data", "left"))
    clouds = os.path.join(out_dir, "clouds")
    t = time.perf_counter()
    visualize.main(["--mode", "reconstruction", "--data_path", view, "--pred_root",
                    hamlyn["saved"], "--sequence", name, "--max_frames", "2", "--out", clouds])
    recon_s = time.perf_counter() - t
    plys = sorted(os.listdir(clouds))
    require(plys == ["000000.ply", "000001.ply"], f"visualize --mode reconstruction: {plys}")
    with open(os.path.join(clouds, plys[0])) as f:
        head = [next(f) for _ in range(3)]
    print(f"[pose tools] visualize --mode pose {plot_s:.1f} s ({drawn}; the trajectories' last "
          f"points GT {pts[0][-1].round(4).tolist()}, scaled prediction "
          f"{pts[1][-1].round(4).tolist()}); --mode reconstruction "
          f"{recon_s:.1f} s, {plys}, {head[2].strip()} ({card_line()})")
    return {"export_s": export_s, "pose_s": pose_s, "ms_per_pair": pose_s / n_pairs * 1e3,
            "plot_s": plot_s, "recon_s": recon_s}


# ---------------------------------------------------------------------------
# The bottleneck ResNets, vitg and the shipped scripts run nowhere above.

# scripts/train_video.sh's training flags exactly with --num_layers 50: the
# position, transform and pose encoders become ResNet-50 (2048-channel top
# maps), which changes no kernel's launches a step (STEP_LAUNCHES)
R50_FLAGS = [*SSB_TRAIN_FLAGS, "--num_layers", "50"]
R50_STEPS = 2
# ResNet-101 and 152: one forward and backward of three encoders (as the
# trainer builds them: frame pairs) on a pair of 64x80, card against
# CPU, in eval mode: each BatchNorm is then affine, where in train mode at
# such sizes one over a few values a channel makes f32 rounding the result
# (tests/test_torch_train_resnet50.py); see check_deep_encoders for the
# bounds
DEEP_DEPTHS, DEEP_HW, DEEP_GRAD_RTOL = (101, 152), (64, 80), 2e-2
# vitg (no option selects it, as in JAX): the whole 40-block trunk at
# 518x644 on VITG_FRAMES frames, f32 and bf16, with and without the fused
# MLP; card against CPU on one 56x70 frame at 4 taps.  f32 tokens within
# VITG_TOL of max(1, their largest): 40 blocks of 1536-wide sums, the card's
# in 3xTF32 (rows 1 and 5) and cuBLAS's order
VITG_TAPS, VITG_CPU_HW, VITG_TOL, VITG_ITERS = (9, 19, 29, 39), (56, 70), 1e-3, 2
# scripts/train_video2.sh:9-15 and :17-20, scripts/train_video1.sh:10-17 and
# :19-22 exactly; train_video1.sh's eval command leaves out the two flags
# its training set (TV1_MISSING), and both packages refuse weights_last at
# the first dvlora layer (tests/test_torch_script_train_video1.py); the
# phase runs the command as written, then with the two flags added
TV2_TRAIN_FLAGS = ["--model_type", "endodav", "--num_workers", "4", "--batch_size", "1",
                   "--T", "16", "--encoder", "vits", "--disable_residual_block",
                   "--disable_conv_head", "--scales", "0", "--depth_reproj", "1e-3",
                   "--depth_flow", "1e-3"]
TV2_EVAL_FLAGS = ["--model_type", "endodav", "--eval_split", "scared_video", "--eval_mono",
                  "--visualize_depth", "--disable_residual_block", "--disable_conv_head"]
TV1_TRAIN_FLAGS = ["--model_type", "endodav", "--num_workers", "4", "--batch_size", "1",
                   "--T", "16", "--encoder", "vits", "--disable_residual_block",
                   "--disable_conv_head", *SSB, "--warm_up_step", "200000", "--visualize_depth",
                   "--depth_reproj", "1e-4", "--temporal_lora", "--tune_spatial_interval", "400",
                   "--tune_temporal_interval", "100"]
TV1_EVAL_FLAGS = TV2_EVAL_FLAGS
TV1_MISSING = [*SSB, "--temporal_lora"]
# scripts/train_video_dac2.sh:10-13 (its training block is commented out
# upstream: the phase's EndoDAC trainer, train_video_dac1.sh's batches with
# the eval's two model flags and the conv head the eval builds, writes
# weights_9)
DAC2_EVAL_FLAGS = ["--model_type", "endodac", "--eval_split", "scared_video", "--eval_mono",
                   "--visualize_depth", "--pre_norm", "--disable_residual_block"]
DAC2_TRAIN_FLAGS = ["--model_type", "endodac", "--batch_size", "16", "--T", "1", "--encoder",
                    "vits", "--pre_norm", "--disable_residual_block"]
# scripts/eval_depth_video.sh:7-9 and :11-13: the default EndoDAV (dvlora,
# residual blocks 2, 5, 8, 11, the conv head)
EVAL_SH_POSE_FLAGS = ["--model_type", "endodav", "--eval_split", "scared_video", "--eval_mono"]
EVAL_SH_HAMLYN_FLAGS = ["--model_type", "endodav", "--eval_split", "hamlyn_video", "--eval_mono"]
# scripts/eval_depth_video_scared_npy.sh:6-7 and scripts/export_gt_depth.sh:
# 8-11 with the root wrapper's --what depth (export_gt_depth.py:6)
SCARED_NPY_FLAGS = ["--eval_split", "scared_video"]
EXPORT_DEPTH_FLAGS = ["--split", "endovis_video", "--useage", "eval", "--what", "depth"]


def save_pose_stack(trainer, folder):
    """The trainer's pose encoder, pose decoder and intrinsics head, the
    components `cli/evaluate_pose` reads, written with the trainer's codec."""
    from endodav_tpu_torch.utils.checkpoint import save_components

    save_components(folder, {n: trainer.mods[n] for n in ("pose_encoder", "pose",
                                                          "intrinsics_head")})


def run_resnet50_training(device, root, pose_folder):
    """`scripts/train_video.sh`'s training with ``--num_layers 50`` at full
    width on the synthetic tree, R50_STEPS steps in f32 and in bf16: three
    ResNet-50 encoders, each step's launches STEP_LAUNCHES, the pose
    decoder on the 2048-channel map; ms/step (step 2) and peak memory.  The
    f32 trainer's pose stack goes to ``pose_folder`` for the pose eval."""
    from endodav_tpu_torch.eval.engine import splits_dir

    legs = {}
    for dtype in ("float32", "bfloat16"):
        trainer = depth_trainer(device, root, splits_dir(), R50_FLAGS, "--compute_dtype", dtype)
        encoders = [trainer.mods[k].encoder for k in ("position_encoder", "transform_encoder",
                                                      "pose_encoder")]
        require(all(e.layer4[-1].conv3.out_channels == 2048 for e in encoders)
                and trainer.mods["pose"].convs["squeeze"].in_channels == 2048,
                "resnet50 training: the encoders are not ResNet-50")
        watch = {k: dict(trainer.mods[k].named_parameters())["encoder.layer4.2.conv3.weight"]
                 for k in ("position_encoder", "pose_encoder")}
        before = {k: p.detach().clone() for k, p in watch.items()}
        label = f"train resnet50 {dtype}"
        r = train_steps(device, trainer, label, first_batches(trainer, R50_STEPS), STEP_LAUNCHES)
        moved = {k: not torch.equal(before[k], p.detach()) for k, p in watch.items()}
        require(all(moved.values()), f"{label}: an encoder's layer4 did not move: {moved}")
        r["ms_per_step"] = r["step_ms"][-1]
        print(f"[{label}] {' '.join(R50_FLAGS)}: step ms {[round(t, 1) for t in r['step_ms']]}, "
              f"peak memory of step {R50_STEPS} {r['peak_bytes'] / 2 ** 30:.2f} GiB, layer4 "
              f"moved {moved} ({card_line()})")
        if dtype == "float32":
            save_pose_stack(trainer, pose_folder)
        legs[dtype] = r
        del trainer
    return legs


def check_deep_encoders(device, depths=DEEP_DEPTHS, hw=DEEP_HW):
    """ResNet-101 and 152: three encoders of frame pairs (seeded weights),
    one eval-mode forward of a pair and a backward of a seeded cotangent on
    the five maps, on the card (the f32 policy) against the CPU in float64:
    each map within TOL[f32] of its largest entry, the encoder's whole
    gradient (every parameter's, as one vector) within DEEP_GRAD_RTOL in
    the 2-norm.  A ReLU whose input sits within rounding of 0 takes either
    side in f32, and a deep net's gradient carries that in a few entries:
    against float64 single parameters' gradients sat up to 3.9% from their
    own largest entry, alike on the card (NVIDIA H100 80GB HBM3, 700 W)
    and on the CPU with and without oneDNN, and a card entry reached
    3.2e-2 of the encoder's largest; in the 2-norm the CPU's f32 stays
    within 3.0e-3 at these inputs (where its largest entry error is 2.65e-2
    of the largest gradient entry), and a wrong block moves the gradient
    by its own size.  The largest entry's error is printed.  Returns the
    errors and the card's ms of a forward and backward of the three."""
    from endodav_tpu_torch.eval.engine import init_random_
    from endodav_tpu_torch.models.resnet import ResNetEncoder
    from endodav_tpu_torch.utils.precision import set_f32_policy

    own_policy("set_f32_policy", set_f32_policy)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(0, 1, (1, *hw, 6)).astype(np.float32))
    out = {}

    def pass_(model, inp, cot):
        maps = model(inp, train=False)
        sum((m * c.to(m)).sum() for m, c in zip(maps, cot)).backward()
        return ([m.detach().cpu().double() for m in maps],
                torch.cat([p.grad.cpu().double().flatten() for p in model.parameters()]))

    for depth in depths:
        errs = {"maps": 0.0, "grads": 0.0, "grad_entry": 0.0}
        card_ms = 0.0
        for k in range(3):  # the position, transform and pose encoders
            cpu = init_random_(ResNetEncoder(depth, num_input_images=2), SEED + k).eval()
            ref = ResNetEncoder(depth, num_input_images=2, dtype=torch.float64).eval()
            ref.load_state_dict(cpu.state_dict())
            gpu = cpu.to(device)
            shapes = [m.shape for m in ref.double()(x.double(), train=False)]
            cot = [torch.from_numpy(rng.standard_normal(s)) for s in shapes]
            maps64, grads64 = pass_(ref, x.double(), cot)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            maps, grads = pass_(gpu, x.to(device), cot)
            torch.cuda.synchronize(device)
            card_ms += (time.perf_counter() - t0) * 1e3
            errs["maps"] = max([errs["maps"]] + [_rel_err(g, w) for g, w in zip(maps, maps64)])
            errs["grads"] = max(errs["grads"], ((grads - grads64).norm()
                                                / grads64.norm()).item())
            errs["grad_entry"] = max(errs["grad_entry"], _rel_err(grads, grads64))
            del cpu, ref, gpu
        print(f"[resnet{depth}] three encoders, a forward and backward of a pair of "
              f"{hw[0]}x{hw[1]} in eval mode, against the CPU in float64: maps {errs['maps']:.3e} "
              f"of their largest entry, the gradient {errs['grads']:.3e} in the 2-norm (its "
              f"largest entry error {errs['grad_entry']:.3e} of the largest); card "
              f"{card_ms:.1f} ms (first calls)")
        require(errs["maps"] <= TOL[torch.float32] and errs["grads"] <= DEEP_GRAD_RTOL,
                f"resnet{depth}: card vs CPU float64 {errs}")
        out[depth] = dict(errs, card_ms=card_ms)
    return out


def run_vitg(device):
    """vitg's whole trunk (`DinoViT(**VIT_CONFIGS["vitg"])`, seeded weights)
    at 518x644 on VITG_FRAMES frames in f32 and bf16, each without and with
    ENDODAV_FUSED_MLP=1: ms a frame (mean of VITG_ITERS warm forwards,
    synchronised), peak memory and the launches of one forward (a flash
    attention a block, 24 heads; a fused MLP a block with the flag, 1536 ->
    6144 -> 1536 on a cluster of 6); card against CPU on one 56x70 frame
    with the flag: f32 within VITG_TOL, bf16 against the CPU's f32 within
    BF16_REL_MAX / BF16_REL_MEAN of the plain bf16 version's own error.
    Returns the launches and the times."""
    from endodav_tpu_torch.eval.engine import init_random_
    from endodav_tpu_torch.models.vit import VIT_CONFIGS, DinoViT
    from endodav_tpu_torch.utils.precision import set_f32_policy

    counters = _serving_counters()
    flash, mlp = counters["flash_attention"], counters["fused_mlp"]
    cfg = VIT_CONFIGS["vitg"]
    t0 = time.perf_counter()
    cpu32 = init_random_(DinoViT(**cfg), SEED).eval()
    cpu16 = DinoViT(**cfg, dtype=torch.bfloat16).eval()
    cpu16.load_state_dict(cpu32.state_dict())
    print(f"[vitg] {sum(p.numel() for p in cpu32.parameters()) / 1e9:.3f} B parameters, "
          f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    small = torch.from_numpy(rng.uniform(-1, 1, (1, *VITG_CPU_HW, 3)).astype(np.float32))
    big = torch.from_numpy(rng.uniform(-1, 1, (VITG_FRAMES, 518, 644, 3)).astype(np.float32))
    flat = lambda taps: torch.cat([torch.cat([t.flatten(), c.flatten()])  # noqa: E731
                                   for t, c in taps]).float().cpu()
    with _env({"ENDODAV_FUSED_MLP": "1"}), torch.inference_mode():
        want = flat(cpu32(small, VITG_TAPS))
        plain16 = flat(cpu16(small, VITG_TAPS))
    own_policy("set_f32_policy", set_f32_policy)
    models = {"float32": cpu32.to(device), "bfloat16": cpu16.to(device)}
    legs, launches = {}, {"flash_attention": 0, "fused_mlp": 0}
    bf16_launches = dict(launches)
    for dtype, model in models.items():
        with _env({"ENDODAV_FUSED_MLP": "1"}), torch.inference_mode():
            got = flat(model(small.to(device), VITG_TAPS))
        if dtype == "float32":
            err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
            require(np.isfinite(err) and err <= VITG_TOL,
                    f"vitg f32: card vs CPU {err} of max(1, the largest token)")
            agree = {"card_vs_cpu": err}
        else:
            card = ((got - want).abs().max().item(), (got - want).abs().mean().item())
            own = ((plain16 - want).abs().max().item(), (plain16 - want).abs().mean().item())
            require(np.isfinite(card[0]) and card[0] <= BF16_REL_MAX * own[0]
                    and card[1] <= BF16_REL_MEAN * own[1],
                    f"vitg bf16: card vs CPU f32 (max, mean) {card}, plain bf16's {own}")
            agree = {"card_vs_cpu_f32": card, "plain_bf16_vs_cpu_f32": own}
        x = big.to(device)
        for fused in (False, True):
            env = {"ENDODAV_FUSED_MLP": "1" if fused else "0"}
            with _env(env), torch.inference_mode():
                model(x, VITG_TAPS)  # warm
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                times = []
                for _ in range(VITG_ITERS):
                    for fn in (flash, mlp):
                        fn.launches = 0
                    t = time.perf_counter()
                    model(x, VITG_TAPS)
                    torch.cuda.synchronize(device)
                    times.append((time.perf_counter() - t) * 1e3 / VITG_FRAMES)
                    seen = {"flash_attention": flash.launches, "fused_mlp": mlp.launches}
                    want_launches = {"flash_attention": cfg["depth"],
                                     "fused_mlp": cfg["depth"] if fused else 0}
                    require(seen == want_launches,
                            f"vitg {dtype} fused={fused}: launches {seen}, expected "
                            f"{want_launches}")
                    for k in seen:
                        (launches if dtype == "float32" else bf16_launches)[k] += seen[k]
            peak = torch.cuda.max_memory_allocated(device)
            name = f"{dtype}{' ENDODAV_FUSED_MLP=1' if fused else ''}"
            legs[name] = {"ms_per_frame": statistics.mean(times), "peak_bytes": peak, **agree}
            print(f"[vitg] {name}: {VITG_FRAMES} frames 518x644, {legs[name]['ms_per_frame']:.2f} "
                  f"ms/frame (mean of {VITG_ITERS}), peak {peak / 2 ** 30:.2f} GiB, launches "
                  f"{seen}, {agree} ({card_line()})")
        del x
    del models, cpu32, cpu16
    torch.cuda.empty_cache()
    return {"legs": legs, "launches": launches, "bf16_launches": bf16_launches}


def script_split(root, train, evaluated):
    """A split directory whose ``scared_video/train_files.txt`` names
    ``train`` and whose val and test lists name ``evaluated``: the scripts'
    trainings and evals cut to those sequences (the trainer's `val` and
    epoch eval both read the val list)."""
    splits = os.path.join(root, "splits_" + os.urandom(4).hex())
    os.makedirs(os.path.join(splits, "scared_video"))
    for split, names in (("train", train), ("val", evaluated), ("test", evaluated)):
        with open(os.path.join(splits, "scared_video", f"{split}_files.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return splits


def run_script_training(device, label, data, splits, n_eval, log_dir, flags, model_dir,
                        min_steps=2):
    """The training CLI's `main` with a script's ``flags`` for one epoch over
    the split directory ``splits`` (its test sequences: ``n_eval`` of
    SCRIPT_FRAMES frames), a log (scalars, panels and `val`) every 2
    batches: every step's losses finite, each kernel's launches
    STEP_LAUNCHES a step, VAL_LAUNCHES a `val` and the epoch eval's
    (`expected_serving_launches`), ``weights_last`` written.  Returns the
    trainer, ``weights_last`` and the record (with the CLI's arguments,
    `instrumented_trainer`'s record and the epoch eval's launches)."""
    from endodav_tpu_torch.cli import train_end_to_end_video

    counters = _kernel_counters()
    args = [*flags, "--data_path", data, "--log_dir", log_dir, "--num_epochs", "1",
            "--log_frequency", "2"]
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        with instrumented_trainer(device) as rec:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            trainer = own_policy("train_end_to_end_video", train_end_to_end_video.main, args)
            train_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    steps, vals = rec["steps"], rec["vals"]
    print(f"[{label}] train_end_to_end_video {' '.join(flags)}: {len(steps)} steps, losses "
          f"{[(round(s['loss'], 6), round(s['loss_0'], 6)) for s in steps]}, step ms "
          f"{[round(s['ms'], 1) for s in steps]}, val {vals}, launches {launches}")
    require(len(steps) == len(trainer.train_loader) >= min_steps,
            f"{label}: {len(steps)} steps, expected the epoch's {len(trainer.train_loader)} "
            f"({min_steps} or more)")
    require(all(np.isfinite([s["loss"], s["loss_0"]]).all() for s in steps),
            f"{label}: a step's loss is not finite")
    require(len(vals) == -(-len(steps) // 2) and np.isfinite(vals).all(),
            f"{label}: val scores {vals}")
    serving, _ = expected_serving_launches(trainer.opt, trainer.eval_forward(),
                                           [{"colors": range(SCRIPT_FRAMES)}] * n_eval)
    expect = {k: n * len(steps) + VAL_LAUNCHES.get(k, 0) * len(vals) + serving.get(k, 0)
              for k, n in STEP_LAUNCHES.items()}
    require(launches == expect, f"{label}: launches {launches}, expected {expect}")
    folder = os.path.join(log_dir, model_dir, "models", "weights_last")
    require(os.path.exists(os.path.join(folder, "depth_model.msgpack")),
            f"{label}: no weights_last")
    ms = statistics.median(s["ms"] for s in steps[1:])
    print(f"[{label}] {ms:.1f} ms/step (median of steps 2-{len(steps)}), the training CLI "
          f"{train_s:.1f} s, peak memory {peak / 2 ** 30:.2f} GiB ({card_line()})")
    return trainer, folder, {"launches": launches, "ms_per_step": ms, "train_s": train_s,
                             "steps": len(steps), "peak_bytes": peak, "args": args,
                             "record": rec, "serving": serving}


def _finite_pose_eval(label, result, n_seq):
    depth = result["depth"]
    metrics = np.concatenate([depth["mean_errors"], depth["mean_temporal"]])
    pose = [(r["ate_mean"], r["re_mean"]) for r in result["pose"]]
    require(np.isfinite(metrics).all() and np.isfinite(pose).all() and len(pose) == n_seq,
            f"{label}: metrics {metrics}, pose {pose}")
    return metrics, pose


def _add(total, launches):
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def run_train_video2_script(device, data, root):
    """`scripts/train_video2.sh`'s two commands on the card, cut to the
    tree's two sequences with ground truth (train, val and test: `val`'s
    clips of T=16 need both): the training CLI with its flags exactly (one scale: the warps of all scales
    go in one launch a kind, so a step's launches stay STEP_LAUNCHES), then
    `evaluate_depth_video --visualize_depth` on ``weights_last``: finite
    metrics, the serving launches, each sequence's aligned depth .npy files
    (and vis.mp4, or JAX's line where the mp4 writer fails); then
    `scripts/eval_depth_video_scared_npy.sh` on those files: no launch, the
    seven metrics within HAMLYN_RESCORE_RTOL of the model run's."""
    from endodav_tpu_torch.cli import evaluate_depth_video
    from endodav_tpu_torch.options import EndoDAVOptions

    seqs = [n for n, gt in SCRIPT_SEQUENCES if gt]
    splits = script_split(root, seqs, seqs)
    trainer, folder, rec = run_script_training(device, "train_video2.sh", data, splits,
                                               len(seqs), os.path.join(root, "log_tv2"),
                                               TV2_TRAIN_FLAGS, "endodav")
    require(trainer.loss_cfg["scales"] == (0,), "train_video2.sh: not one scale")
    del trainer
    total = dict(rec["launches"])
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        opt = EndoDAVOptions().parse([*TV2_EVAL_FLAGS, "--data_path", data,
                                      "--load_weights_folder", folder])
        result, out, cli_s, launches = run_cli("evaluate_depth_video",
                                               lambda: evaluate_depth_video.evaluate(opt), opt,
                                               [SCRIPT_FRAMES] * len(seqs))
        _add(total, launches)
        require(np.isfinite(result["mean_errors"]).all(),
                f"train_video2.sh eval: metrics {result['mean_errors']}")
        saved = os.path.join(folder, "eval", "scared_video")
        for name in seqs:
            npys = sorted(os.listdir(os.path.join(saved, name, "depth")))
            require(npys == [f"{i:06d}.npy" for i in range(SCRIPT_FRAMES)],
                    f"train_video2.sh eval: {name} saved {len(npys)} depth files")
            require(os.path.exists(os.path.join(saved, name, "vis.mp4"))
                    or "[eval] mp4 export failed" in out, f"train_video2.sh eval: {name} vis.mp4")
        print(f"[train_video2.sh] evaluate_depth_video {' '.join(TV2_EVAL_FLAGS)}: metrics "
              f"{result['mean_errors'].tolist()}, launches {launches}, the CLI {cli_s:.1f} s")
        counters = _serving_counters()
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        rescore = evaluate_depth_video.evaluate(EndoDAVOptions().parse(
            ["--data_path", data, *SCARED_NPY_FLAGS, "--pred_root", saved]))
        rescore_s = time.perf_counter() - t
    rel = np.abs(rescore["mean_errors"] - result["mean_errors"]) / np.abs(result["mean_errors"])
    print(f"[eval_depth_video_scared_npy.sh] --pred_root: metrics "
          f"{rescore['mean_errors'].tolist()}, relative to the model run {rel.tolist()}, "
          f"{rescore_s:.1f} s")
    require(not any(fn.launches for fn in counters.values()), "--pred_root launched a kernel")
    require(float(rel.max()) <= HAMLYN_RESCORE_RTOL,
            f"scared --pred_root: metrics relative {rel} to the model run's")
    return dict(rec, launches=total, cli_s=cli_s, rescore_s=rescore_s, rescore_rel=float(rel.max()))


def run_train_video1_script(device, data, root):
    """`scripts/train_video1.sh`'s two commands on the card, cut to the
    tree's two sequences with ground truth: the training CLI with its flags
    exactly; its eval command as written refuses ``weights_last`` at the
    first dvlora layer, as JAX's does (tests/test_torch_script_train_video1
    .py); with TV1_MISSING added, `evaluate_depth_video_pose`: finite metrics
    and the serving launches."""
    from endodav_tpu_torch.cli import evaluate_depth_video_pose
    from endodav_tpu_torch.options import EndoDAVOptions

    seqs = [n for n, gt in SCRIPT_SEQUENCES if gt]
    splits = script_split(root, seqs, seqs)
    trainer, folder, rec = run_script_training(device, "train_video1.sh", data, splits,
                                               len(seqs), os.path.join(root, "log_tv1"),
                                               TV1_TRAIN_FLAGS, "endodav")
    require(trainer.loss_cfg["depth_reproj"] == 1e-4 and trainer.sched_cfg["temporal_lora"],
            "train_video1.sh: flags not taken")
    del trainer
    total = dict(rec["launches"])
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        exact = EndoDAVOptions().parse([*TV1_EVAL_FLAGS, "--data_path", data,
                                        "--load_weights_folder", folder])
        try:
            evaluate_depth_video_pose.evaluate(exact)
        except ValueError as e:
            require("lora_U" in str(e) and "pretrained/blocks_0/mlp/fc1" in str(e),
                    f"train_video1.sh eval command: {e}")
            print(f"[train_video1.sh] the eval command as written refuses weights_last, as "
                  f"JAX's: {e}")
        else:
            require(False, "train_video1.sh eval command: dvlora loaded ssb's weights")
        opt = EndoDAVOptions().parse([*TV1_EVAL_FLAGS, *TV1_MISSING, "--data_path", data,
                                      "--load_weights_folder", folder])
        result, _, cli_s, launches = run_cli(
            "evaluate_depth_video_pose", lambda: evaluate_depth_video_pose.evaluate(opt), opt,
            [SCRIPT_FRAMES] * len(seqs))
    _add(total, launches)
    metrics, pose = _finite_pose_eval("train_video1.sh eval", result, len(seqs))
    print(f"[train_video1.sh] evaluate_depth_video_pose {' '.join(TV1_EVAL_FLAGS)} with "
          f"{' '.join(TV1_MISSING)} added: depth and TAE/TAS {metrics.tolist()}, (ATE, RE) "
          f"{pose}, launches {launches}, the CLI {cli_s:.1f} s")
    return dict(rec, launches=total, cli_s=cli_s)


def run_dac2_script(device, root):
    """`scripts/train_video_dac2.sh`'s command on the card on the dac1 tree:
    the EndoDAC trainer at DAC2_TRAIN_FLAGS (the eval's model) takes one step (SINGLE_STEP_LAUNCHES) and writes ``weights_9`` at epoch
    9, then `evaluate_depth_video_pose` with the script's flags exactly:
    finite metrics and the single-frame serving launches."""
    from endodav_tpu_torch.cli import evaluate_depth_video_pose
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    data, splits = os.path.join(root, "data"), os.path.join(root, "splits")
    opt = EndoDAVOptions().parse([*DAC2_TRAIN_FLAGS, "--data_path", data,
                                  "--log_dir", os.path.join(root, "log_dac2"), "--num_workers",
                                  "2", "--seed", str(SEED)])
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        trainer = own_policy("Trainer", Trainer, opt, device)
        model = trainer.mods["depth_model"]
        require(model.config["pre_norm"] and not model.config["residual_block_indexes"],
                "train_video_dac2.sh: the model flags were not taken")
        step = train_steps(device, trainer, "train_video_dac2.sh", first_batches(trainer, 1),
                           SINGLE_STEP_LAUNCHES, peak_from=1)
        trainer.epoch = 9
        folder = trainer.save_model("epoch")
        require(folder.endswith(os.path.join("endodac", "models", "weights_9")),
                f"train_video_dac2.sh: wrote {folder}")
        del trainer
        n_seq = len([n for n, gt in SCRIPT_SEQUENCES if gt])
        eval_opt = EndoDAVOptions().parse([*DAC2_EVAL_FLAGS, "--data_path", data,
                                           "--load_weights_folder", folder])
        result, _, cli_s, launches = run_cli(
            "evaluate_depth_video_pose", lambda: evaluate_depth_video_pose.evaluate(eval_opt),
            eval_opt, [DAC1_FRAMES] * n_seq)
    metrics, pose = _finite_pose_eval("train_video_dac2.sh", result, n_seq)
    print(f"[train_video_dac2.sh] evaluate_depth_video_pose {' '.join(DAC2_EVAL_FLAGS)} on "
          f"weights_9: depth and TAE/TAS {metrics.tolist()}, (ATE, RE) {pose}, launches "
          f"{launches}, the CLI {cli_s:.1f} s ({card_line()})")
    total = dict(step["launches"])
    _add(total, launches)
    return {"launches": total, "cli_s": cli_s, "step_ms": step["step_ms"]}


def run_eval_depth_video_sh(device, data, hamlyn, root):
    """`scripts/eval_depth_video.sh`'s two commands on the card on one
    weights folder of the default EndoDAV (the engine's seeded weights) and
    a seeded pose stack: `evaluate_depth_video_pose` on the SCARED tree's
    first sequence with ground truth, then `evaluate_depth_video_hamlyn` on
    the Hamlyn tree; finite metrics and each CLI's serving launches."""
    from endodav_tpu_torch.cli import evaluate_depth_video_hamlyn, evaluate_depth_video_pose
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.models.decoders import IntrinsicsHead, PoseDecoder
    from endodav_tpu_torch.models.resnet import ResNetEncoder
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.utils.checkpoint import save_components

    model = own_policy("build_depth_model", engine.build_depth_model,
                       eval_options(["--no_cuda"]), torch.device("cpu"))
    require(model.lora_type == "dvlora" and model.config["residual_block_indexes"]
            and model.config["conv_head"], "eval_depth_video.sh: not the default model")
    folder = os.path.join(root, "weights_default")
    save_components(folder, {
        "depth_model": model,
        "pose_encoder": engine.init_random_(ResNetEncoder(18, num_input_images=2), SEED),
        "pose": engine.init_random_(PoseDecoder(512, num_frames_to_predict_for=2), SEED + 1),
        "intrinsics_head": engine.init_random_(IntrinsicsHead(256), SEED + 2)},
        metadata={"height": 256, "width": 320, "use_stereo": False, "dash_phase2": False})
    del model
    n_seq = 1
    splits = script_split(root, [], [n for n, gt in SCRIPT_SEQUENCES if gt][:n_seq])
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        opt = EndoDAVOptions().parse([*EVAL_SH_POSE_FLAGS, "--data_path", data,
                                      "--load_weights_folder", folder])
        result, _, pose_s, pose_launches = run_cli(
            "evaluate_depth_video_pose", lambda: evaluate_depth_video_pose.evaluate(opt), opt,
            [SCRIPT_FRAMES] * n_seq)
    metrics, pose = _finite_pose_eval("eval_depth_video.sh", result, n_seq)
    hamlyn_splits = os.path.join(os.path.dirname(hamlyn["data"]), "splits_hamlyn")
    with _env({"ENDODAV_TPU_SPLITS_DIR": hamlyn_splits}):
        args = [*EVAL_SH_HAMLYN_FLAGS, "--data_path", hamlyn["data"], "--load_weights_folder",
                folder]
        hresult, _, hamlyn_s, hamlyn_launches = run_cli(
            "evaluate_depth_video_hamlyn", lambda: evaluate_depth_video_hamlyn.main(args),
            EndoDAVOptions().parse(args), [HAMLYN_FRAMES] * len(hamlyn["names"]))
    require(np.isfinite(hresult["mean_errors"]).all(),
            f"eval_depth_video.sh Hamlyn: metrics {hresult['mean_errors']}")
    print(f"[eval_depth_video.sh] evaluate_depth_video_pose {' '.join(EVAL_SH_POSE_FLAGS)}: "
          f"depth and TAE/TAS {metrics.tolist()}, (ATE, RE) {pose}, launches {pose_launches}, "
          f"{pose_s:.1f} s; evaluate_depth_video_hamlyn {' '.join(EVAL_SH_HAMLYN_FLAGS)}: "
          f"metrics {hresult['mean_errors'].tolist()}, {hresult['mean_infer_ms']:.3f} ms/frame, "
          f"launches {hamlyn_launches}, {hamlyn_s:.1f} s ({card_line()})")
    total = dict(pose_launches)
    _add(total, hamlyn_launches)
    return {"launches": total, "pose_s": pose_s, "hamlyn_s": hamlyn_s,
            "hamlyn_ms_per_frame": hresult["mean_infer_ms"]}


def run_export_gt_depth(data, root):
    """`scripts/export_gt_depth.sh` (`cli/export_gt`, EXPORT_DEPTH_FLAGS)
    over an ``endovis_video/test_files.txt`` of the tree's frames with
    ground truth, written into a split directory of its own: the packed
    depths finite, one a line, at the frames' size; the repository's
    ``splits/`` unchanged."""
    from endodav_tpu_torch.cli import export_gt

    splits = os.path.join(root, "splits_export")
    os.makedirs(os.path.join(splits, "endovis_video"))
    folders = [n.split("/", 1)[1] for n, gt in SCRIPT_SEQUENCES if gt]
    lines = [f"{folder}	{i}	l" for folder in folders for i in range(1, SCRIPT_FRAMES, 8)]
    with open(os.path.join(splits, "endovis_video", "test_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    repo_split = os.path.join(os.path.dirname(os.path.abspath(__file__)), "splits",
                              "endovis_video")
    before = sorted(os.listdir(repo_split)) if os.path.isdir(repo_split) else None
    with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
        t = time.perf_counter()
        export_gt.main(["--data_path", data, *EXPORT_DEPTH_FLAGS])
        seconds = time.perf_counter() - t
    gt = np.load(os.path.join(splits, "endovis_video", "gt_depths.npz"))["data"]
    after = sorted(os.listdir(repo_split)) if os.path.isdir(repo_split) else None
    print(f"[export_gt_depth.sh] export_gt {' '.join(EXPORT_DEPTH_FLAGS)}: {gt.shape} "
          f"{gt.dtype} in {seconds:.1f} s")
    require(gt.shape == (len(lines), 512, 640) and np.isfinite(gt).all() and before == after,
            f"export_gt_depth.sh: depths {gt.shape}, the repository's split {before} -> {after}")
    return {"export_s": seconds}


def run_pose_eval_r50(device, data, splits, weights):
    """`cli/evaluate_pose --eval_mono --num_layers 50` on the ResNet-50
    trainer's pose stack (``weights``), on the split the pose tools wrote:
    the CLI builds `PoseDecoder(2048)` (once a sequence); finite ATE, RE and
    intrinsics."""
    from endodav_tpu_torch.cli import evaluate_pose
    from endodav_tpu_torch.models import decoders

    built, real = [], decoders.PoseDecoder

    class Recording(real):
        def __init__(self, num_ch_enc, *a, **k):
            built.append(num_ch_enc)
            super().__init__(num_ch_enc, *a, **k)

    decoders.PoseDecoder = Recording
    try:
        with _env({"ENDODAV_TPU_SPLITS_DIR": splits}):
            t = time.perf_counter()
            with captured_stdout() as out:
                results = own_policy("evaluate_pose", evaluate_pose.main,
                                     ["--data_path", data, "--load_weights_folder", weights,
                                      "--eval_mono", "--num_layers", "50"])
            seconds = time.perf_counter() - t
    finally:
        decoders.PoseDecoder = real
    report = [ln for ln in out.getvalue().splitlines()
              if ln.startswith(("sq", "fx", "fy", "cx", "cy"))]
    require(built and set(built) == {2048} and sorted(results) == [1, 2] and all(
        np.isfinite([r["ate_mean"], r["re_mean"]]).all() for r in results.values()),
        f"evaluate_pose --num_layers 50: decoders {built}, {report}")
    n_pairs = 2 * (SCRIPT_FRAMES - 2)
    print(f"[pose tools] evaluate_pose --eval_mono --num_layers 50 {seconds:.1f} s, "
          f"{seconds / n_pairs * 1e3:.2f} ms/pair with the nets' build: {report}")
    return {"pose_s": seconds, "ms_per_pair": seconds / n_pairs * 1e3}


# kernel-name fragments -> the categories of the profiles' breakdowns
PROFILE_CATEGORIES = [
    ("port: grid_sample_fwd", ("grid_sample_fwd_kernel",)),
    ("port: grid_sample_bwd coord-only",
     tuple(f"grid_sample_bwd_kernel<{c}, false" for c in range(1, 5))),
    ("port: grid_sample_bwd fused", ("grid_sample_bwd_kernel",)),
    ("port: splat", ("splat_kernel",)),
    ("port: flash attention", ("::attn_kernel<",)),
    ("port: temporal block", ("::qkv_kernel<", "::out_kernel<")),
    ("port: fused MLP", ("::mlp_kernel<",)),
    ("port: fused RCU", ("::rcu_kernel<",)),
    ("port: temporal attention", ("::temporal_attn_kernel<",)),
    ("cuDNN conv data grad", ("dgrad",)),
    ("cuDNN conv weight grad", ("wgrad", "winogradWgrad")),
    ("cuDNN conv layout transposes", ("nhwcToNchw", "nchwToNhwc")),
    ("cuDNN FFT convs", ("fft2d", "fft", "pointwise_mult_and_sum_complex", "cf32cf32")),
    ("cuDNN conv forward", ("fprop", "convolve", "conv2d", "implicit_convolve")),
    ("int8 GEMM (torch._int_mm)", ("i8", "s8", "int8", "imma")),
    ("cuBLAS/CUTLASS GEMM", ("gemm", "gemv", "sgemm")),
    ("host-to-device and other copies", ("Memcpy",)),
    ("memset", ("Memset",)),
    ("gather/scatter/index", ("scatter_gather", "index", "gather")),
    ("reductions", ("reduce_kernel",)),
    ("SSIM average pools", ("avg_pool2d",)),
    ("elementwise", ("elementwise", "Functor")),
]


def profile_run(label, fn, trace_dir, trace_name):
    """``fn()`` under torch.profiler: device time by category and by kernel
    name, the device's idle share of the run, and the Chrome trace in
    ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    print(f"[profile {label}] wall {wall:.1f} ms, device time {busy:.1f} ms, device idle "
          f"{100 * (1 - busy / wall):.1f}% ({card_line()})")
    cats = {}
    for e in kernels:
        cat = next((c for c, frags in PROFILE_CATEGORIES if any(f in e.key for f in frags)),
                   "other")
        ms, n = cats.get(cat, (0.0, 0))
        cats[cat] = (ms + e.device_time_total / 1e3, n + e.count)
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile {label}] {ms:9.3f} ms {n:6d}x  {cat}")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:25]:
        print(f"[profile {label}] kernel {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:100]}")
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, trace_name))


def profile_step(trainer, batch, trace_dir):
    """One more training step under the profiler."""
    profile_run("train step", lambda: trainer.train_one_batch(batch), trace_dir,
                "train_step_trace.json")


SERVING_PROFILES = (("vitl serving", VITL_ARGS),
                    ("vits serving", [*HEADLINE, "--chunk_windows", "2"]),
                    ("vitb EndoDAC serving", ENDODAC_VITB), ("vits EndoDAC serving", ENDODAC),
                    ("AF-SfM serving", AFSFM))


def profile_serving(device, sequence, trace_dir, legs=SERVING_PROFILES):
    """Serving of one 64-frame sequence under the profiler, after one
    warm-up run, in the main path's vitl configuration (device stitch),
    in the vits headline's (host stitch, its device->host copies
    included) and on the single-frame path (EndoDAC vitb and vits,
    AF-SfM on the sequence at 256x320): inference alone, without the
    metrics."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import (infer_video_depth,
                                                        infer_video_depth_single_frame)

    for label, args in legs:
        opt = eval_options(args)
        forward = engine.depth_window_forward(engine.build_depth_model(opt, device))

        def run():
            if opt.model_type == "afsfm":
                return infer_video_depth_single_frame(
                    forward, half_size([sequence])[0]["colors"], device=device)
            if opt.model_type == "endodac":
                return infer_video_depth_single_frame(forward, sequence["colors"],
                                                      device=device)
            return infer_video_depth(forward, sequence["colors"], tuple(opt.depth_image_shape),
                                     opt.chunk_windows, device,
                                     "device" if opt.fast_stitch else "host", forward.dedup)

        run()
        profile_run(label, run, trace_dir, f"{label.replace(' ', '_')}_trace.json")
        del forward


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from endodav_tpu_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from endodav_tpu_torch.bench import tile_error

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # both nvcc builds at once
        for f in [pool.submit(_build.library), pool.submit(tile_error.library)]:
            f.result()
    print(f"[build] kernels and the tile's error check built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")

    with ieee_f32():
        tile_rows = check_tile_error(device)
        flash_rows = check_flash(device)
        flash_grad_err = check_flash_grad(device)
        temporal_rows = check_temporal(device)
        mlp_rows = check_fused_mlp(device)
        rcu_rows = check_fused_rcu(device)
        temporal_train_rows = check_temporal(device, TEMPORAL_TRAIN_SHAPES, t=16)
        tattn_rows, tattn_grad_err = check_temporal_attention(device)
        int8_row = check_int8(device)
        warp_rows = check_warps(device)
        warp_bf16_err = check_warps_bf16(device)
        check_warp_branches(device)
        cp_rows = check_warps_cp(device)
        splat_row = check_splat(device)
    counters = _serving_counters()
    flash, block = counters["flash_attention"], counters["fused_temporal_block"]
    fused_rcu, fused_mlp = counters["fused_rcu"], counters["fused_mlp"]
    temporal_attention = counters["temporal_attention"]

    model_err = max(r["max"] for r in (
        check_whole_model(device),
        check_whole_model(device, env={"ENDODAV_FUSED_RCU": "1"},
                          expect={fused_rcu: RCU_PER_SUFFIX}),
        check_whole_model(device, pos_embedding_type="rope", expect={temporal_attention: 8}),
        check_whole_model(device, ["--encoder", "vitl", "--merge_lora",
                                   "--disable_residual_block"], (112, 140), 4)))
    # bf16, each with its kernel's launches at bf16: one forward of a clip
    # runs a flash attention a ViT block, two temporal blocks a motion
    # module (APE) or two temporal attentions (RoPE), seven RCUs
    bf16 = dict(frames=4, dtype=torch.bfloat16)
    whole_bf16 = [
        check_whole_model(device, expect={flash: 12, block: 8}, **bf16),
        check_whole_model(device, env={"ENDODAV_FUSED_RCU": "1"},
                          expect={fused_rcu: RCU_PER_SUFFIX}, **bf16),
        check_whole_model(device, ["--merge_lora"], env={"ENDODAV_FUSED_MLP": "1"},
                          expect={fused_mlp: 12}, **bf16),
        check_whole_model(device, pos_embedding_type="rope",
                          expect={temporal_attention: 8, block: 0}, **bf16)]
    # the single-frame models: EndoDAC vits and vitb as built, vitb merged
    # with the fused MLP (768 columns, a cluster of 3) and the fused RCU at
    # C=128, vits with BatchNorm RCUs (never fused), AF-SfM
    from endodav_tpu_torch.eval.engine import init_random_
    from endodav_tpu_torch.models.endodac import EndoDAC

    with_bn = lambda m: init_random_(EndoDAC(**{**m.config, "use_bn": True}), SEED).eval()  # noqa: E731
    single_err = max(r["max"] for r in (
        check_whole_model(device, ENDODAC, expect={flash: 12}),
        check_whole_model(device, ENDODAC_VITB, frames=4, expect={flash: 12}),
        check_whole_model(device, [*ENDODAC_VITB, "--merge_lora"], frames=4,
                          env={"ENDODAV_FUSED_MLP": "1", "ENDODAV_FUSED_RCU": "1"},
                          expect={flash: 12, fused_mlp: 12, fused_rcu: RCU_PER_SUFFIX}),
        check_whole_model(device, ENDODAC, frames=4, env={"ENDODAV_FUSED_RCU": "1"},
                          expect={flash: 12, fused_rcu: 0}, rebuild=with_bn),
        check_whole_model(device, AFSFM, frames=4, expect={flash: 0, fused_rcu: 0}),
        check_whole_model(device, [*AFSFM, "--num_layers", "50"], frames=4,
                          expect={flash: 0, fused_rcu: 0})))
    # the LoRA family: ssb with its motion modules adapted too, Dash
    # in each phase (the engine's seed weights make its index and singular
    # directions nonzero), galora and flora (no CLI flag: rebuilt), EndoDAC
    # with ssb; the shipped eval's ssb model in bf16
    from endodav_tpu_torch.models.endodav import EndoDAV
    from endodav_tpu_torch.models.lora import set_dash_phase2

    def as_variant(variant):
        return lambda m: init_random_(EndoDAV(**{**m.config, "lora_type": variant}), SEED).eval()

    dash = ["--lora_type", "dash", "--temporal_lora"]
    window = {flash: 12, block: 8}
    lora_err = max(r["max"] for r in (
        check_whole_model(device, [*SSB, "--temporal_lora"], frames=4, expect=window),
        check_whole_model(device, dash, frames=4, expect=window),
        check_whole_model(device, dash, frames=4, expect=window,
                          rebuild=lambda m: set_dash_phase2(m, True)),
        check_whole_model(device, frames=4, expect=window, rebuild=as_variant("galora")),
        check_whole_model(device, frames=4, expect=window, rebuild=as_variant("flora")),
        check_whole_model(device, ["--model_type", "endodac", *SSB], frames=4,
                          expect={flash: 12})))
    whole_bf16.append(check_whole_model(device, SHIPPED_EVAL[:4], expect=window, **bf16))
    switch_rows = check_switches(device)
    test_simple_err = check_test_simple(device)
    vitg = run_vitg(device)

    # one 64-frame sequence a leg: the host metrics of a 512x640 sequence
    # take most of a leg's wall time
    sequences = synthetic_sequences(n_seq=1)
    runs = [run_main_path(VITL_ARGS, sequences, device),
            run_main_path([*HEADLINE, "--chunk_windows", "2"], sequences, device),
            run_main_path([*HEADLINE, "--chunk_windows", "2"], sequences, device,
                          env={"ENDODAV_FUSED_MLP": "1"}),
            run_main_path([*HEADLINE, "--chunk_windows", "2"], sequences, device,
                          env={"ENDODAV_FUSED_RCU": "1"}),
            run_main_path([], sequences, device),
            # single-frame serving: EndoDAC vitb as built, then merged with the
            # fused MLP and RCU, vits; AF-SfM on the sequence at 256x320
            run_main_path(ENDODAC_VITB, sequences, device),
            run_main_path([*ENDODAC_VITB, "--merge_lora"], sequences, device,
                          env={"ENDODAV_FUSED_MLP": "1", "ENDODAV_FUSED_RCU": "1"}),
            run_main_path(ENDODAC, sequences, device),
            run_main_path(AFSFM, half_size(sequences), device)]
    shipped_runs, shipped = run_shipped_eval(sequences, device)
    runs += shipped_runs
    evaluate_row = run_evaluate_depth(device)
    afsfm50_row = run_evaluate_depth(device, [*AFSFM, "--num_layers", "50"], h=256, w=320)
    for r in runs:
        warm = (f", warm {r['warm_ms_per_frame']:.3f} (inference only)"
                if "warm_ms_per_frame" in r else "")
        print(f"[main path] {r['name']}: {r['ms_per_frame']:.3f} ms/frame{warm} ({card})")
    streams = [run_streaming(HEADLINE, sequences[0], device, env={"ENDODAV_FUSED_RCU": "1"}),
               run_streaming([], sequences[0], device, env={"ENDODAV_FUSED_RCU": "1"})]
    for r in streams:
        print(f"[streaming] {r['name']}: median {r['ms_per_push']:.3f} ms a push, "
              f"{r['ms_per_window']:.3f} ms a fired window ({card})")
    # the TPU benchmark's headline (vits, dedup, f16 transfer, device
    # stitch) and its baseline leg, and vitl, in bf16 beside f32
    bf16_legs = [run_bf16_serving([*HEADLINE, "--chunk_windows", "2"], sequences[0], device,
                                  plain_frames=4),
                 run_bf16_serving(VITL_ARGS, sequences[0], device)]
    baseline = run_sequential_baseline(sequences[0], device)
    for r in bf16_legs:
        print(f"[bf16 serving] {r['name']}: ms/frame f32 {r['ms_per_frame']['f32']:.3f}, bf16 "
              f"{r['ms_per_frame']['bf16']:.3f}; (max, mean) |Δdisp| bf16 vs f32 "
              f"{r['bf16_vs_f32']} ({card})")
    print(f"[sequential baseline] ms/frame {baseline['ms_per_frame']} ({card})")
    args = sys.argv[1:]
    if "--profile-serving" in args:
        profile_serving(device, sequences[0], args[args.index("--profile-serving") + 1])

    r50_weights = tempfile.TemporaryDirectory(prefix="resnet50_pose_", dir=os.getcwd())
    with tempfile.TemporaryDirectory(prefix="scared_synth_", dir=os.getcwd()) as root:
        t0 = time.perf_counter()
        write_scared_tree(root)
        print(f"[train] synthetic SCARED tree written in {time.perf_counter() - t0:.1f} s")
        check_small_step(device, root)
        check_small_step(device, root, env={"ENDODAV_WARP_CP": "1"})
        check_small_step(device, root, dtype="bfloat16")
        check_small_step(device, root, extra=("--num_layers", "50"))
        deep = check_deep_encoders(device)
        r50 = run_resnet50_training(device, root, r50_weights.name)
        trace_dir = args[args.index("--profile-step") + 1] if "--profile-step" in args else None
        train = run_training(device, root, trace_dir=trace_dir)
        dash_errs = check_dash_boundary(device, root)
        ssb_train = run_ssb_training(device, root)
        # the other depth models read an endovis split of the tree's sequences
        from endodav_tpu_torch.data.readers import readlines

        splits = os.path.join(root, "splits_endovis")
        write_endovis_split(splits, readlines(SPLIT), readlines(VAL_SPLIT))
        os.makedirs(os.path.join(splits, "scared_video"))
        with open(os.path.join(splits, "scared_video", "val_files.txt"), "w") as f:
            f.write("\n".join(readlines(VAL_SPLIT)) + "\n")
        single, single_launches = run_single_frame_training(device, root, splits)
        bf16_train = run_bf16_training(device, root)
        rope_train = run_rope_training(device, root)
    with tempfile.TemporaryDirectory(prefix="training_script_", dir=os.getcwd()) as root:
        script = run_training_script(device, root)
        # the scripts a user runs after training, on the weights it saved
        weights = os.path.join(root, "log", "endodav", "models", "weights_last")
        hamlyn = run_hamlyn_script(device, root, weights)
        data, splits = os.path.join(root, "data"), os.path.join(root, "splits")
        tools = run_pose_tools(device, data, splits, weights, hamlyn)
        pose50 = run_pose_eval_r50(device, data, splits, r50_weights.name)
        r50_weights.cleanup()
        # the shipped scripts no other phase runs
        tv2 = run_train_video2_script(device, data, root)
        tv1 = run_train_video1_script(device, data, root)
        eval_sh = run_eval_depth_video_sh(device, data, hamlyn, root)
        export = run_export_gt_depth(data, root)
    with tempfile.TemporaryDirectory(prefix="training_dac1_", dir=os.getcwd()) as root:
        dac1 = run_dac1_script(device, root)
        dac2 = run_dac2_script(device, root)

    def entry(name, source, replaces, launches, max_abs_err, head, shape, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs_err,
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "shape": shape, **extra}

    def head_of(rows, shape):
        return next(r for r in rows if r["shape"] == shape and r["dtype"] == "float32")

    def served(name):
        return sum(r["launches"][name] for r in runs + streams + bf16_legs
                   + [baseline, evaluate_row, afsfm50_row, hamlyn])

    def single_frame_shapes(rows, shapes):
        """The rows of the single-frame path's shapes (both dtypes)."""
        keys = ("shape", "dtype", "err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return [{k: r[k] for k in keys} for r in rows if r["shape"] in shapes]

    def at_bf16(name):
        return (sum(r["launches"][name] for r in bf16_legs)
                + sum(r["launches"].get(name, 0) for r in whole_bf16))

    f32 = lambda rows: max(r["err"] for r in rows if r["dtype"] == "float32")  # noqa: E731
    bf16_err = lambda rows: max(r["err"] for r in rows if r["dtype"] == "bfloat16")  # noqa: E731
    block_rows = [r for r in temporal_rows if r["kernel"] == "block"]
    grouped_rows = [r for r in temporal_rows if r["kernel"] == "grouped"]
    colour = next(r for r in warp_rows if r["call"] == "colour synthesis")
    depth = next(r for r in warp_rows if r["call"] == "depth warps")
    colour_cp = next(r for r in cp_rows if r["call"] == "colour synthesis")
    consistency_cp = next(r for r in cp_rows if r["call"] == "flow_consistency")
    # bf16 training: the ssb steps and the single-frame models' bf16 steps
    bf16_trained = {k: n + sum(r["launches"][k] for label, r in single.items()
                               if label.endswith("bf16")) + rope_train["bfloat16"]["launches"][k]
                    for k, n in bf16_train["bfloat16"]["launches"].items()}
    trained = {k: (n + ssb_train["launches"][k] + script["launches"][k] + dac1["launches"][k]
                   + single_launches[k] + bf16_train["float32"]["launches"][k]
                   + bf16_train["bfloat16"]["launches"][k] + rope_train["float32"]["launches"][k]
                   + rope_train["bfloat16"]["launches"][k])
               for k, n in train["launches"].items()}
    wide = sum(r["wide_temporal"] for r in runs + streams + bf16_legs + [baseline])
    wide_bf16 = sum(r["wide_temporal"] for r in bf16_legs)
    warp_src, warp_py = "endodav_tpu_torch/csrc/warp.cu", "endodav_tpu/kernels/warp_matmul.py"
    cp_err = lambda row, keys: max(row[f"{k}_vs_plain"] for k in keys)  # noqa: E731
    kernels = [
        entry("flash_attention", "endodav_tpu_torch/csrc/flash_attention.cu",
              "endodav_tpu/kernels/flash_attention.py:43",
              served("flash_attention") + trained["flash_attention"],
              max(f32(flash_rows), flash_grad_err[torch.float32]),
              head_of(flash_rows, "B=64 N=1703 H=6 Dh=64"), "B=64 N=1703 H=6 Dh=64",
              bf16_launches=at_bf16("flash_attention") + bf16_trained["flash_attention"],
              bf16_max_abs_err=max(bf16_err(flash_rows), flash_grad_err[torch.bfloat16]),
              bf16_train_launches=bf16_trained["flash_attention"],
              single_frame=single_frame_shapes(flash_rows, ("B=8 N=321 H=6 Dh=64",
                                                            "B=8 N=321 H=12 Dh=64")),
              vitg=single_frame_shapes(flash_rows, (f"B={VITG_FRAMES} N=1703 H=24 Dh=64",)),
              training=single_frame_shapes(flash_rows, ("B=16 N=321 H=6 Dh=64",
                                                        "B=8 N=321 H=12 Dh=64"))),
        # one route and one counter for both TPU kernels; the C >= 512
        # share comes from the models' widths (the counter's total is
        # checked against the configuration in each run)
        entry("fused_temporal_block", "endodav_tpu_torch/csrc/fused_temporal_block.cu",
              "endodav_tpu/kernels/fused_temporal_block.py:76",
              served("fused_temporal_block") + trained["fused_temporal_block"] - wide,
              max(f32(block_rows), f32(temporal_train_rows)),
              head_of(block_rows, "rows=1702 T=32 C=192"),
              "rows=1702 T=32 C=192",
              bf16_launches=(at_bf16("fused_temporal_block") - wide_bf16
                             + bf16_trained["fused_temporal_block"]),
              bf16_max_abs_err=max(bf16_err(block_rows), bf16_err(temporal_train_rows)),
              bf16_train_launches=bf16_trained["fused_temporal_block"],
              training=single_frame_shapes(temporal_train_rows, tuple(
                  f"rows={n} T=16 C={c}" for c, n in TEMPORAL_TRAIN_SHAPES))),
        entry("fused_temporal_block_grouped", "endodav_tpu_torch/csrc/fused_temporal_block.cu",
              "endodav_tpu/kernels/fused_temporal_block.py:120", wide, f32(grouped_rows),
              head_of(grouped_rows, "rows=1702 T=32 C=1024"), "rows=1702 T=32 C=1024",
              bf16_launches=wide_bf16, bf16_max_abs_err=bf16_err(grouped_rows)),
        entry("temporal_attention", "endodav_tpu_torch/csrc/temporal_attention.cu",
              "endodav_tpu/kernels/temporal_attention.py:31",
              served("temporal_attention") + trained["temporal_attention"],
              max(f32(tattn_rows), tattn_grad_err[torch.float32]),
              head_of(tattn_rows, "rows=1280 T=16 H=8 Dh=8"), "rows=1280 T=16 H=8 Dh=8",
              bf16_launches=at_bf16("temporal_attention") + bf16_trained["temporal_attention"],
              bf16_max_abs_err=max(bf16_err(tattn_rows), tattn_grad_err[torch.bfloat16]),
              bf16_train_launches=bf16_trained["temporal_attention"],
              training=single_frame_shapes(tattn_rows, ("rows=1280 T=16 H=8 Dh=8",
                                                        "rows=320 T=16 H=8 Dh=24",
                                                        "rows=80 T=16 H=8 Dh=48"))),
        entry("fused_mlp", "endodav_tpu_torch/csrc/fused_mlp.cu",
              "endodav_tpu/kernels/fused_mlp.py:73", served("fused_mlp"), f32(mlp_rows),
              head_of(mlp_rows, "rows=54496 384->1536->384"), "rows=54496 384->1536->384",
              bf16_launches=at_bf16("fused_mlp"), bf16_max_abs_err=bf16_err(mlp_rows),
              single_frame=single_frame_shapes(mlp_rows, ("rows=2568 384->1536->384",
                                                          "rows=2568 768->3072->768")),
              vitg=single_frame_shapes(mlp_rows, (f"rows={VITG_FRAMES * 1703} 1536->6144->1536",
                                                  "rows=4096 2048->8192->2048"))),
        entry("fused_rcu", "endodav_tpu_torch/csrc/fused_rcu.cu",
              "endodav_tpu/kernels/fused_rcu.py:80", served("fused_rcu"), f32(rcu_rows),
              head_of(rcu_rows, "[32,148,184,64]"), "[32,148,184,64]",
              bf16_launches=at_bf16("fused_rcu"), bf16_max_abs_err=bf16_err(rcu_rows),
              single_frame=single_frame_shapes(rcu_rows, tuple(
                  f"[8,{h},{w},{c}]" for c in (64, 128) for h, w in ENDODAC_RCU_HW))),
        entry("grid_sample_fwd", warp_src, f"{warp_py}:327", trained["grid_sample_fwd"],
              max(r["err_out"] for r in warp_rows), colour["fwd"],
              f"colour synthesis, {colour['shape']}"),
        entry("grid_sample_fwd_cp", warp_src, f"{warp_py}:374", trained["grid_sample_fwd_cp"],
              max(cp_err(r, ("err_out",)) for r in cp_rows), colour_cp["fwd"],
              f"colour synthesis, {colour_cp['shape']}"),
        entry("grid_sample_bwd_coord", warp_src, f"{warp_py}:436",
              trained["grid_sample_bwd_coord"],
              max(max(r["err_dfx"], r["err_dfy"]) for r in warp_rows if "err_dimg" not in r),
              colour["bwd"], f"colour synthesis, {colour['shape']}"),
        entry("grid_sample_bwd_coord_cp", warp_src, f"{warp_py}:637",
              trained["grid_sample_bwd_coord_cp"], cp_err(colour_cp, ("err_dfx", "err_dfy")),
              colour_cp["bwd"], f"colour synthesis, {colour_cp['shape']}"),
        entry("grid_sample_bwd_fused", warp_src, f"{warp_py}:488",
              trained["grid_sample_bwd_fused"],
              max(max(r["err_dfx"], r["err_dfy"], r["err_dimg"])
                  for r in warp_rows if "err_dimg" in r),
              depth["bwd"], f"depth warps, {depth['shape']}"),
        entry("grid_sample_bwd_fused_cp", warp_src, f"{warp_py}:562",
              trained["grid_sample_bwd_fused_cp"],
              cp_err(consistency_cp, ("err_dfx", "err_dfy")), consistency_cp["bwd"],
              f"flow consistency, {consistency_cp['shape']} (checked only: the step's "
              f"fused backward is C=1, which never takes planes)"),
        entry("splat", warp_src, f"{warp_py}:1029", trained["splat"],
              max(splat_row["err_occ"], splat_row["err_dx"], splat_row["err_dy"]), splat_row,
              splat_row["shape"]),
    ]
    # the bottleneck ResNets', vitg's and the scripts' launches, f32 then bf16
    extra, extra_bf16, extra_bf16_train = {}, {}, {}
    for r in (r50["float32"], tv2, tv1, dac2, eval_sh, vitg):
        _add(extra, r["launches"])
    _add(extra_bf16, vitg["bf16_launches"])
    _add(extra_bf16_train, r50["bfloat16"]["launches"])
    for k in kernels:
        k["launches"] += extra.get(k["name"], 0)
        if "bf16_launches" in k:
            k["bf16_launches"] += (extra_bf16.get(k["name"], 0)
                                   + extra_bf16_train.get(k["name"], 0))
        if "bf16_train_launches" in k:
            k["bf16_train_launches"] += extra_bf16_train.get(k["name"], 0)
    require(len(kernels) == 13, f"{len(kernels)} kernel entries, expected 13")
    missing = [k["name"] for k in kernels if k["launches"] == 0
               and k["name"] != "grid_sample_bwd_fused_cp"]
    require(not missing, f"kernels of the main paths never launched: {missing}")
    no_bf16 = [k["name"] for k in kernels[:6] if not k["bf16_launches"]]
    require(not no_bf16, f"serving kernels never launched at bf16: {no_bf16}")
    no_bf16_train = [k["name"] for k in kernels if "bf16_train_launches" in k
                     and not k["bf16_train_launches"]]
    require(not no_bf16_train, f"kernels never launched in bf16 training: {no_bf16_train}")
    worst = max((r for r in tile_rows), key=lambda r: r["tile"])
    print(f"[summary] tile f32 error: at most {worst['tile']:.3e} (K={worst['k']} "
          f"{worst['dist']}); one f32 product up to "
          f"{max(r['f32_product'] for r in tile_rows):.3e}")
    print(f"[summary] int8_dense {int8_row['ms']:.3f} ms vs f32 linear "
          f"{int8_row['f32_linear_ms']:.3f} ms at {int8_row['shape']} ({card})")
    print(f"[summary] single-frame whole models max |Δdisp| {single_err:.3e}, test_simple "
          f"{test_simple_err:.3e}; switches {switch_rows}")
    print(f"[summary] whole model max |Δdisp| {model_err:.3e}; training "
          f"{train['ms_per_step']:.1f} ms/step, peak {train['peak_bytes'] / 2 ** 30:.2f} GiB; "
          f"ENDODAV_WARP_CP=1 steps {[round(t, 1) for t in train['cp_step_ms']]} ms")
    print(f"[summary] LoRA family whole models max |Δdisp| {lora_err:.3e}; shipped ssb eval "
          f"the CLI's ms/frame {shipped['cli_ms_per_frame']}, warm {shipped['ms_per_frame']}, "
          f"as built vs merged {shipped['as_built_vs_merged']}; ssb training "
          f"(scripts/train_video.sh) step ms {[round(t, 1) for t in ssb_train['step_ms']]}, peak "
          f"{ssb_train['peak_bytes'] / 2 ** 30:.2f} GiB; dash boundary errors {dash_errs} ({card})")
    print(f"[summary] training script (scripts/train_video.sh, one epoch of "
          f"{len(script['step_ms'])} steps): {script['ms_per_step']:.1f} ms/step, training CLI "
          f"{script['train_s']:.1f} s (epoch eval {script['eval_s']:.1f} s), eval CLI "
          f"{script['cli_s']:.1f} s, peak {script['peak_bytes'] / 2 ** 30:.2f} GiB ({card})")
    print(f"[summary] train_video_dac1.sh (EndoDAC vits, one epoch of "
          f"{len(dac1['step_ms'])} steps of 16 frames): {dac1['ms_per_step']:.1f} ms/step, "
          f"training CLI {dac1['train_s']:.1f} s (epoch eval {dac1['eval_s']:.1f} s), eval CLI "
          f"{dac1['cli_s']:.1f} s, peak {dac1['peak_bytes'] / 2 ** 30:.2f} GiB; "
          + "; ".join(f"{k} step ms {[round(t, 1) for t in r['step_ms']]} peak "
                      f"{r['peak_bytes'] / 2 ** 30:.2f} GiB" for k, r in single.items())
          + f" ({card})")
    print(f"[summary] bf16 training (scripts/train_video.sh ssb): ms/step f32 "
          f"{bf16_train['float32']['ms_per_step']:.1f} bf16 "
          f"{bf16_train['bfloat16']['ms_per_step']:.1f}, peak f32 "
          f"{bf16_train['float32']['peak_bytes'] / 2 ** 30:.2f} GiB bf16 "
          f"{bf16_train['bfloat16']['peak_bytes'] / 2 ** 30:.2f} GiB, step-1 losses relative "
          f"{bf16_train['rel']} (reported: JAX's bf16 grids, BF16_LOSS_RTOL); bf16-fed warps "
          f"max |err| {warp_bf16_err:.3e} of max(1, the largest entry) ({card})")
    print(f"[summary] the scripts after training, on weights_last: eval_depth_video1.sh "
          f"(Hamlyn, {HAMLYN_SEQS} x {HAMLYN_FRAMES} frames) {hamlyn['ms_per_frame']:.3f} "
          f"ms/frame, the CLI {hamlyn['cli_s']:.1f} s; eval_depth_video_hamlyn_npy.sh "
          f"{hamlyn['rescore_s']:.1f} s, metrics within {hamlyn['rescore_rel']:.2e} of the model "
          f"run's; --max_length {HAMLYN_MAX_LENGTH} {hamlyn['max_length_s']:.1f} s; export_gt "
          f"{tools['export_s']:.1f} s; eval_pose.sh {tools['pose_s']:.1f} s "
          f"({tools['ms_per_pair']:.2f} ms/pair); visualize pose {tools['plot_s']:.1f} s, "
          f"reconstruction {tools['recon_s']:.1f} s; RoPE ssb training step ms f32 "
          f"{[round(t, 1) for t in rope_train['float32']['step_ms']]} bf16 "
          f"{[round(t, 1) for t in rope_train['bfloat16']['step_ms']]} ({card})")
    print(f"[summary] ResNet-50 (scripts/train_video.sh --num_layers 50): ms/step f32 "
          f"{r50['float32']['ms_per_step']:.1f} bf16 {r50['bfloat16']['ms_per_step']:.1f}, peak "
          f"f32 {r50['float32']['peak_bytes'] / 2 ** 30:.2f} GiB bf16 "
          f"{r50['bfloat16']['peak_bytes'] / 2 ** 30:.2f} GiB; ResNet-101/152 card vs CPU "
          f"{ {d: (v['maps'], v['grads']) for d, v in deep.items()} }; "
          f"AF-SfM-50 evaluate_depth {afsfm50_row['ms_per_frame']:.3f} ms/frame; evaluate_pose "
          f"--num_layers 50 {pose50['ms_per_pair']:.2f} ms/pair ({card})")
    print(f"[summary] vitg 518x644, {VITG_FRAMES} frames, ms/frame: "
          + ", ".join(f"{k} {v['ms_per_frame']:.2f} (peak {v['peak_bytes'] / 2 ** 30:.2f} GiB)"
                      for k, v in vitg["legs"].items()) + f" ({card})")
    print(f"[summary] train_video2.sh {tv2['ms_per_step']:.1f} ms/step, training CLI "
          f"{tv2['train_s']:.1f} s, eval CLI {tv2['cli_s']:.1f} s, scared --pred_root "
          f"{tv2['rescore_s']:.1f} s (within {tv2['rescore_rel']:.2e}); train_video1.sh "
          f"{tv1['ms_per_step']:.1f} ms/step, training CLI {tv1['train_s']:.1f} s, eval CLI with "
          f"{' '.join(TV1_MISSING)} {tv1['cli_s']:.1f} s; train_video_dac2.sh eval CLI "
          f"{dac2['cli_s']:.1f} s; eval_depth_video.sh pose eval {eval_sh['pose_s']:.1f} s, "
          f"Hamlyn {eval_sh['hamlyn_s']:.1f} s ({eval_sh['hamlyn_ms_per_frame']:.3f} ms/frame); "
          f"export_gt_depth.sh {export['export_s']:.1f} s ({card})")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
