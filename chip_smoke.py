#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and training step on one CUDA card.

    python3 chip_smoke.py [--profile-step TRACE_DIR] [--profile-serving TRACE_DIR]

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from `endodav_tpu_torch/csrc/` with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the serving path and of the training step: flash attention
     (f32, bf16, and its gradient), the fused temporal block and its
     head-grouped kernel (vitl's C=1024) in f32 and bf16, the fused MLP at
     vits and vitl widths, the int8 serving GEMM (`int8_dense`); the
     grid-sample forward and both backward kernels at the four warp calls
     of the training step, and the forward splat; with the kernel's, the
     plain version's and one PyTorch call's times;
  4. the full-width vits EndoDAV (random weights from a seed) on one
     8-frame 224x280 clip, and the full-width merged vitl on one 4-frame
     112x140 clip, on the card with the kernels (int8 off) against the CPU
     with the plain versions;
  5. the serving path as the CLI runs it (engine.build_depth_model ->
     depth_window_forward -> evaluate_video_sequences) over synthetic
     SCARED-like 64-frame sequences: vitl 518x644 merged (dedup in taps
     mode, int8 GEMMs, device stitch), the vits 518x644 headline (dedup in
     prefix mode) without and with ENDODAV_FUSED_MLP=1, and the 224x280
     CLI default (window path); finite metrics and the launches of every
     serving kernel per encode batch and per window chunk checked;
  6. one small training step (64x96 frames, T=4, ViT input 56x70) on the
     card with the kernels against the same step on the CPU with the
     plain versions: both phase losses, the gradients and the updated
     values of a LoRA B and a pose-decoder weight;
  7. the training step at full width, as `scripts/train_video.sh`
     configures it (vits, 256x320, batch 1, T=16, dvlora with
     --warm_up_step 2): `Trainer` built through the option parser on a
     synthetic SCARED tree written from the seed, 4 steps of
     `train_one_batch` with finite losses, the expected parameter changes
     and the expected launches of every kernel per step; ms/step and the
     peak memory;
  8. a JSON line per kernel and, last, the device line.

``--profile-step TRACE_DIR`` adds a `torch.profiler` run of one more
full-width step, ``--profile-serving TRACE_DIR`` one of vitl serving over
a 64-frame sequence: device time by kernel name, and the Chrome trace in
TRACE_DIR.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
# f32: summation order of the kernels' products and the online-softmax
# rescaling differ from the plain version's; bf16: the kernels' inputs and
# the rounded intermediates (y and the attention output) carry 8 bits of
# mantissa, compared with the plain version in f32 on the same inputs.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MODEL_TOL = 2e-4  # whole model, card (kernels, TF32 off) vs CPU (plain versions)
# flash attention (B, N): 224x280 window chunks (2 x 32 frames); 518x644
# window chunks and dedup encode batches of 32 frames at vits (H=6) and
# vitl (H=16)
FLASH_SHAPES = [(64, 321, 6), (64, 1703, 6), (32, 1703, 16)]
# temporal block (C, rows) of one 518x644 window: vits's four motion
# modules; vitl's C=1024 ones (head-grouped kernel) and its C=256 ones
TEMPORAL_SHAPES = [(192, 1702), (384, 437), (64, 6808), (1024, 1702), (1024, 437), (256, 1702),
                   (256, 6808)]
# fused MLP (C, H, rows): a dedup encode batch of 32 518x644 frames
MLP_SHAPES = [(384, 1536, 32 * 1703), (1024, 4096, 32 * 1703)]
# the serving configurations of the main path: the 518x644 headline, and
# vitl at it as the CLI serves it (dedup in taps mode, int8 by default)
HEADLINE = ["--depth_image_shape", "518", "644", "--merge_lora", "--disable_residual_block"]
VITL_ARGS = ["--encoder", "vitl", *HEADLINE, "--chunk_windows", "1", "--fast_stitch"]
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
TRAIN_HW, TRAIN_T, SPLIT = (256, 320), 16, "splits/scared_video/train_files.txt"
# scripts/train_video.sh with the trainer's default --lora_type dvlora and
# --warm_up_step 2, so that steps 1-2 train the LoRA A/B and steps 3-4 the
# dvlora vectors
TRAIN_FLAGS = ["--model_type", "endodav", "--encoder", "vits", "--batch_size", "1",
               "--disable_residual_block", "--disable_conv_head", "--depth_reproj", "1e-2",
               "--temporal_lora", "--tune_spatial_interval", "400",
               "--tune_temporal_interval", "100", "--lora_type", "dvlora", "--warm_up_step", "2",
               "--num_workers", "2", "--seed", str(SEED)]
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
#   backward is a plain recompute); temporal block: 0 (the training route
#   of the motion modules, models/motion.py)
STEP_LAUNCHES = {"grid_sample_fwd": 4, "grid_sample_bwd_coord": 2, "grid_sample_bwd_fused": 1,
                 "splat": 2, "flash_attention": 12, "fused_temporal_block": 0}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


def bound(nbytes: float, flops: float, dtype=torch.float32) -> tuple[float, str]:
    """Least ms the card could take: the larger of the bytes over HBM rate
    and the operations over the peak rate of their type."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
                row["bound_ms"], row["bound_by"] = bound(
                    x.element_size() * b * n * 4 * c, 4.0 * b * heads * n * n * dh, dtype)
            print(f"[flash_attention] {row}")
            require(err <= TOL[dtype], f"flash_attention {row}: max |err| above {TOL[dtype]}")
            rows.append(row)
    return rows


def check_flash_grad(device, b=16, n=321, heads=6, dh=64):
    """The kernel path's d_qkv (CUDA forward, recompute backward) against
    the plain version's autograd, at the training step's ViT shape."""
    from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention

    c = heads * dh
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    qkv = torch.randn((b, n, 3 * c), generator=g, device=device)
    cot = torch.randn((b, n, c), generator=g, device=device)
    x = qkv.clone().requires_grad_()
    out = qkv_attention(x, heads)
    require(out.grad_fn is not None, "qkv_attention returned a result without grad_fn")
    (got,) = torch.autograd.grad(out, x, cot)
    xr = qkv.clone().requires_grad_()
    ref = attention_reference(*(xr[..., i * c:(i + 1) * c].reshape(b, n, heads, dh)
                                for i in range(3)), dh ** -0.5).reshape(b, n, c)
    (want,) = torch.autograd.grad(ref, xr, cot)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"[flash_attention grad] B={b} N={n}: max |err| {err:.3e} (largest entry {scale:.3e})")
    require(err <= TOL[torch.float32] * max(1.0, scale),
            f"flash_attention gradient: max |err| {err} above {TOL[torch.float32]}")
    return err


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
    """The temporal block's kernels (C < 512 the block kernel, C >= 512 the
    head-grouped kernel) against the plain versions, in f32 and bf16."""
    from endodav_tpu_torch.kernels.fused_temporal_block import (GROUPED_MIN_C,
                                                                 fused_temporal_block,
                                                                 grouped_reference_block,
                                                                 reference_block)
    from endodav_tpu_torch.models.motion import sinusoidal_time_encoding

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    for c, nrows in shapes:
        plain = grouped_reference_block if c >= GROUPED_MIN_C else reference_block
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
            want = plain(ref_args[0], gamma, beta, pe, *ref_args[1:5], ref_args[5], heads)
            got = fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            tol = TOL[dtype]
            row = dict(shape=f"rows={nrows} T={t} C={c}", dtype=str(dtype)[6:], err=err,
                       kernel="grouped" if c >= GROUPED_MIN_C else "block")
            if timing:
                t_ = time_calls({
                    "plain": lambda: plain(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads),
                    "kernel": lambda: fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo,
                                                           bod, heads),
                    "library": lambda: unfused_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod,
                                                     heads)})
                row["ms"], row["plain_ms"], row["library_ms"] = (t_["kernel"], t_["plain"],
                                                                 t_["library"])
                # x read and the output written once, the weights once; four
                # C x C products per token and the T x T attention per row
                row["bound_ms"], row["bound_by"] = bound(
                    xd.element_size() * (2 * nrows * t * c + 4 * c * c + c) + 4 * (2 * c + t * c),
                    2.0 * nrows * t * 4 * c * c + 4.0 * nrows * t * t * c, dtype)
            print(f"[fused_temporal_block] {row}")
            require(err <= tol, f"fused_temporal_block {row}: max |err| above {tol}")
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
            row = dict(shape=f"rows={nrows} {c}->{h}->{c}", dtype=str(dtype)[6:], err=err)
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
                row["bound_ms"], row["bound_by"] = bound(
                    xd.element_size() * (2 * nrows * c + 2 * c * h) + 4 * (h + c),
                    4.0 * nrows * c * h, dtype)
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


# the warp calls of the training step at 256x320, batch 1, T=16, four
# scales: (name, images, channels, img_tile, zeros mode, align_corners,
# image gradient); the registration warp repeats colour synthesis's call
# with flow-shaped coordinates; the flow-consistency warp is JAX's fourth
# warp call, whose map no loss reads (the port's step leaves it out)
WARP_CALLS = [("colour synthesis", 32, 3, 4, False, True, False),
              ("registration flow_warp", 32, 3, 4, False, True, False),
              ("flow_consistency", 128, 2, 1, False, False, True),
              ("depth warps", 240, 1, 1, True, True, True)]


def check_warps(device, hw=TRAIN_HW):
    """Each warp kernel against its plain version at the training step's
    shapes: the forward, every gradient, the times of the kernel, the plain
    version and one PyTorch call (F.grid_sample forward, aten's
    grid_sampler_2d_backward), and the bound."""
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
        if img_grad:
            row["err_dimg"] = (got[3] - want[3]).abs().max().item()
            row["rel_dimg"] = _rel_err(got[3], want[3])
            require(row["rel_dimg"] <= ATOMIC_RTOL,
                    f"{name}: d_img relative err {row['rel_dimg']} above {ATOMIC_RTOL}")

        # times: the kernels alone, the plain forward, the plain backward
        # from a kept graph, and the library calls on NCHW copies with a
        # normalised grid made here (its images expanded over img_tile)
        inp = img.permute(0, 3, 1, 2).repeat_interleave(tile, 0).contiguous()
        if align:
            grid = torch.stack([fx / (w - 1) * 2 - 1, fy / (h - 1) * 2 - 1], -1)
        else:
            grid = torch.stack([(2 * fx + 1) / w - 1, (2 * fy + 1) / h - 1], -1)
        pad = "zeros" if zeros else "border"
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
        bwd = time_calls({
            "plain": lambda: torch.autograd.grad(plain_out, wrt, cot, retain_graph=True),
            "kernel": bwd_kernel,
            "library": lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_nchw, inp, grid, 0, 0 if zeros else 1, align, mask)})
        p, img_b, c4 = bg * h * w, b_img * h * w * c * 4, c * 4
        # forward: image, coordinates and output once; a few flops a sample
        row["fwd"] = dict(ms=fwd["kernel"], plain_ms=fwd["plain"], library_ms=fwd["library"])
        row["fwd"]["bound_ms"], row["fwd"]["bound_by"] = bound(img_b + p * (8 + c4),
                                                               p * (16 + 8 * c))
        # backward: image, coordinates and cotangent read once, the two
        # coordinate gradients (and d_img) written once
        row["bwd"] = dict(ms=bwd["kernel"], plain_ms=bwd["plain"], library_ms=bwd["library"])
        row["bwd"]["bound_ms"], row["bwd"]["bound_by"] = bound(
            img_b * (2 if img_grad else 1) + p * (16 + c4), p * (16 + 16 * c))
        print(f"[warp] {row}")
        rows.append(row)
        del plain_out, wrt
    return rows


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


def splat_agreement(x, y, h, w):
    """The splat kernel's map against the plain version's on the same
    coordinates [B, P]: the relative error, the pixels whose `occ > 0.95`
    mask flips, and the plain map's pixels within the kernel's largest
    error of 0.95 (where the atomics' summation order alone can flip it)."""
    from endodav_tpu_torch.kernels import warp_matmul as W

    got, want = W.splat_cuda(x, y, h, w), W.splat_reference(x, y, h, w)
    err = (got - want).abs().max()
    return dict(rel_occ=_rel_err(got, want), flips=int(((got > 0.95) != (want > 0.95)).sum()),
                near=int(((want - 0.95).abs() <= err).sum()))


def check_splat(device, n=128, hw=TRAIN_HW):
    """The splat kernel against its plain version at the training step's
    occlusion-map shape: the map, its gradient, the 0.95 mask flips, the
    times and the bound; the library yardstick is one
    index_put_(accumulate=True) over the four corners' indices.  The flips
    are also counted on flow-shaped coordinates (`_coords`: a smooth
    displacement plus noise, so the mass of neighbours overlaps), where a
    pixel may lie within rounding of 0.95; they are reported, not required
    to be 0 (`run_training` requires 0 on the step's own coordinates)."""
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

    # the library call's indices and values: the plain version's four corners
    x1, y1 = torch.floor(x), torch.floor(y)
    idx, vals = [], []
    base = (torch.arange(n, device=device) * (h * w))[:, None]
    for cx, cy in ((x1 + 1, y1 + 1), (x1 + 1, y1), (x1, y1 + 1), (x1, y1)):
        ok = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        val = (1 - (x - cx).abs()) * (1 - (y - cy).abs()) * ok
        idx.append((base + (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()).reshape(-1))
        vals.append(val.reshape(-1))
    idx, vals = torch.cat(idx), torch.cat(vals)
    acc = torch.zeros(n * h * w, device=device)
    t = time_calls({"plain": lambda: W.splat_reference(x, y, h, w),
                    "kernel": lambda: W.splat_cuda(x, y, h, w),
                    "library": lambda: acc.index_put_((idx,), vals, accumulate=True)})
    row.update(ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"])
    # coordinates read once, the map written once
    row["bound_ms"], row["bound_by"] = bound(4 * (2 * n * h * w + n * h * w), 40.0 * n * h * w)
    print(f"[splat] {row}")
    return row


def eval_options(args):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse(["--seed", str(SEED), *args])


def check_whole_model(device, args=(), image_shape=(224, 280), frames=8):
    """A full-width EndoDAV on the card (kernels; int8 off, as
    build_depth_model leaves it) vs the CPU (plain versions)."""
    from endodav_tpu_torch.eval import engine

    opt = eval_options(["--no_cuda", "--depth_image_shape", *map(str, image_shape), *args])
    cpu_model = engine.build_depth_model(opt, torch.device("cpu"))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(SEED)
    video = torch.from_numpy(rng.uniform(0.0, 1.0, (1, frames, 256, 320, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu_model(video)
        got = gpu_model(video.to(device))
    errs = {s: (got[("disp", s)].cpu() - want[("disp", s)]).abs().max().item() for s in range(4)}
    print(f"[whole model] {opt.encoder} {' '.join(args)} {image_shape} T={frames}: "
          f"max |Δdisp| per scale {errs}")
    for s, e in errs.items():
        require(np.isfinite(e) and e <= MODEL_TOL,
                f"whole model {opt.encoder} scale {s}: max |Δdisp| {e} above {MODEL_TOL}")
    del cpu_model, gpu_model
    return max(errs.values())


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

    return {"flash_attention": qkv_attention, "fused_temporal_block": ftb.fused_temporal_block,
            "fused_temporal_block_grouped": ftb.launch_grouped, "fused_mlp": fused_mlp}


def expected_serving_launches(opt, forward, sequences):
    """Launches of each serving kernel in one run, from the configuration:
    per encode batch (dedup) or per window chunk (window path) one flash
    attention a ViT block, and one fused MLP a block where it routes; per
    window chunk two temporal blocks a motion module, on the grouped kernel
    where the module has C >= 512."""
    from endodav_tpu_torch.eval.video_inference import window_indices
    from endodav_tpu_torch.kernels.fused_temporal_block import GROUPED_MIN_C
    from endodav_tpu_torch.models.endodav import ENDODAV_CONFIGS
    from endodav_tpu_torch.models.vit import VIT_CONFIGS
    from endodav_tpu_torch.ops.quant import resolve_int8
    from endodav_tpu_torch.utils.envflags import env_on

    depth = VIT_CONFIGS[opt.encoder]["depth"]
    cfg = ENDODAV_CONFIGS[opt.encoder]
    widths = (cfg["out_channels"][2], cfg["out_channels"][3], cfg["features"], cfg["features"])
    grouped = sum(2 for c in widths if c >= GROUPED_MIN_C)
    chunks = sum(-(-len(window_indices(len(s["colors"]))) // opt.chunk_windows) for s in sequences)
    dedup = forward.dedup
    batches = (sum(-(-len(s["colors"]) // dedup.encode_batch_for(len(s["colors"])))
                   for s in sequences) if dedup is not None else chunks)
    mlp = (env_on("ENDODAV_FUSED_MLP") and forward.model.lora_type == "none"
           and not resolve_int8(forward.model.int8_serving))
    return ({"flash_attention": depth * batches, "fused_temporal_block": (8 - grouped) * chunks,
             "fused_temporal_block_grouped": grouped * chunks,
             "fused_mlp": depth * batches if mlp else 0},
            dict(chunks=chunks, encode_batches=batches if dedup is not None else 0))


def run_main_path(args, sequences, device, env=None):
    """build_depth_model -> depth_window_forward -> evaluate_video_sequences
    with ``env`` set for the run, the serving kernels' launch counts set
    to 0 just before and read just after, and checked."""
    from endodav_tpu_torch.cli.evaluate_depth_video import report
    from endodav_tpu_torch.eval import engine

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        opt = eval_options(args)
        forward = engine.depth_window_forward(engine.build_depth_model(opt, device))
        counters = _serving_counters()
        torch.cuda.reset_peak_memory_stats(device)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = engine.evaluate_video_sequences(opt, sequences, forward, device=device)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        expect, passes = expected_serving_launches(opt, forward, sequences)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    name = " ".join(f"{k}={v}" for k, v in env.items()) + " " + (" ".join(args) or "CLI default")
    for line in report(result):
        print(f"[main path {name.strip()}] {line}")
    print(f"[main path] {passes} dedup={forward.dedup is not None} "
          f"prefix_mode={getattr(forward.dedup, 'prefix_mode', None)} "
          f"int8={forward.model.int8_serving} launches={launches} wall={wall:.3f} s "
          f"peak {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    vals = np.concatenate([result["mean_errors"], result["mean_temporal"]])
    require(bool(np.all(np.isfinite(vals))), f"main path metrics not finite: {vals}")
    require(launches == expect, f"main path {name}: launches {launches}, expected {expect}")
    return {"args": args, "name": name.strip(), "ms_per_frame": result["mean_infer_ms"],
            "launches": launches, **passes, "metrics": [float(v) for v in vals]}


def write_scared_tree(root, n_frames=24, h=512, w=640, step=(3, 4)):
    """Left frames (PNG, through PIL) of every sequence of the training
    split, made with numpy from the seed: a window drifting by `step`
    pixels a frame over a smooth texture with fine detail.  24 frames a
    sequence give the 23 sequences 33 clips of T=16."""
    from PIL import Image

    from endodav_tpu_torch.data.readers import readlines

    rng = np.random.default_rng(SEED)
    bh, bw = h + step[0] * n_frames, w + step[1] * n_frames
    yy, xx = np.meshgrid(np.linspace(0, bh / h, bh), np.linspace(0, bw / w, bw), indexing="ij")
    fine = rng.uniform(-12, 12, (bh, bw, 3))
    for name in readlines(SPLIT):
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


def check_small_step(device, root):
    """One training step of a small configuration on the card (kernels)
    and on the CPU (plain versions), from the same seed weights and the
    same loader batch."""
    from endodav_tpu_torch.train.trainer import Trainer

    args = ["--height", "64", "--width", "96", "--T", "4", "--depth_image_shape", "56", "70"]
    gpu = Trainer(train_options(root, *args), device)
    cpu = Trainer(train_options(root, *args, "--no_cuda"))
    batch = next(iter(cpu.train_loader))
    got = gpu.train_one_batch(batch)
    with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's reduced-precision convs
        want = cpu.train_one_batch(batch)
    errs = {}
    for k in ("loss_0", "loss"):
        a, b = float(got[k]), float(want[k])
        errs[k] = abs(a - b) / abs(b)
        require(np.isfinite(a) and errs[k] <= STEP_LOSS_RTOL,
                f"small step {k}: card {a} vs CPU {b}, relative {errs[k]}")
    named = {"lora_B": ("depth_model", "pretrained.blocks.5.mlp.fc1.lora_B"),
             "pose_2": ("pose", "convs.pose_2.weight")}
    for label, (comp, pname) in named.items():
        pg = dict(gpu.mods[comp].named_parameters())[pname]
        pc = dict(cpu.mods[comp].named_parameters())[pname]
        require(pg.grad is not None and pc.grad is not None, f"small step: {pname} got no gradient")
        gg, gc = pg.grad.cpu(), pc.grad
        errs[f"grad {label}"] = (gg - gc).abs().max().item() / gc.abs().max().item()
        require(errs[f"grad {label}"] <= STEP_GRAD_RTOL,
                f"small step: gradient of {pname} relative err {errs[f'grad {label}']}")
        sure = gc.abs() > 1e-3 * gc.abs().max()
        errs[f"update {label}"] = (pg.detach().cpu() - pc.detach())[sure].abs().max().item()
        require(errs[f"update {label}"] <= STEP_UPDATE_ATOL,
                f"small step: updated {pname} differs by {errs[f'update {label}']}")
    print(f"[small step] card vs CPU, 64x96 T=4 ViT 56x70: losses card "
          f"{float(got['loss_0']):.6f}/{float(got['loss']):.6f}, errors {errs}")
    return errs


def _kernel_counters():
    from endodav_tpu_torch.kernels import warp_matmul as W
    from endodav_tpu_torch.kernels.flash_attention import qkv_attention
    from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block

    return {"grid_sample_fwd": W.grid_sample_fwd_cuda,
            "grid_sample_bwd_coord": W.grid_sample_bwd_coord_cuda,
            "grid_sample_bwd_fused": W.grid_sample_bwd_fused_cuda, "splat": W.splat_cuda,
            "flash_attention": qkv_attention, "fused_temporal_block": fused_temporal_block}


def run_training(device, root, steps=4, trace_dir=None):
    """`Trainer` at full width on the synthetic tree: `steps` steps of
    `train_one_batch`, each checked; returns the launches and times."""
    from endodav_tpu_torch.ops import sampling
    from endodav_tpu_torch.train.trainer import Trainer

    opt = train_options(root, "--height", str(TRAIN_HW[0]), "--width", str(TRAIN_HW[1]),
                        "--T", str(TRAIN_T))
    trainer = Trainer(opt, device)
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

    for step in range(1, steps + 1):
        if step == 1:
            sampling.splat_mm = keep_coords
        batch = next(it)
        before = {k: p.detach().clone() for k, p in watch.items()}
        counts = {k: adam_steps(p) for k, p in watch.items()}
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        scalars = trainer.train_one_batch(batch)
        loss, loss_0 = float(scalars["loss"]), float(scalars["loss_0"])  # waits for the step
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counters.items()}
        changed = {k: not torch.equal(before[k], p.detach()) for k, p in watch.items()}
        # updated = Adam stepped the parameter: its gate was open and it got
        # a gradient (dvlora vectors at init get gradients near 1e-15, whose
        # first Adam step, lr * g / (|g| + 1e-8), is below their f32 ulp)
        updated = {k: adam_steps(p) == counts[k] + 1 for k, p in watch.items()}
        print(f"[train] step {step}: loss {loss:.6f} loss_0 {loss_0:.6f} {times[-1]:.1f} ms "
              f"launches {launches} changed {changed} updated {updated}")
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
        require(launches == STEP_LAUNCHES,
                f"step {step}: launches {launches}, expected {STEP_LAUNCHES}")
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
          f"2-{steps} {peak / 2 ** 30:.2f} GiB ({card_line()})")
    if trace_dir:
        profile_step(trainer, next(it), trace_dir)
    it.close()
    return {"launches": totals, "ms_per_step": ms_step, "step_ms": times, "peak_bytes": peak,
            "splat": agree}


# kernel-name fragments -> the categories of the profiles' breakdowns
PROFILE_CATEGORIES = [
    ("port: grid_sample_fwd", ("grid_sample_fwd_kernel",)),
    ("port: grid_sample_bwd coord-only",
     tuple(f"grid_sample_bwd_kernel<{c}, false" for c in range(1, 5))),
    ("port: grid_sample_bwd fused", ("grid_sample_bwd_kernel",)),
    ("port: splat", ("splat_kernel",)),
    ("port: flash attention", ("::attn_kernel<",)),
    ("port: grouped temporal block", ("::grouped_kernel<",)),
    ("port: fused temporal block", ("::block_kernel<",)),
    ("port: fused MLP", ("::mlp_kernel<",)),
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


def profile_serving(device, sequence, trace_dir):
    """Serving of one 64-frame sequence under the profiler, after one
    warm-up run, in the main path's vitl configuration (device stitch)
    and in the vits headline's (host stitch, its device->host copies
    included): inference alone, without the metrics."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth

    for label, args in (("vitl serving", VITL_ARGS),
                        ("vits serving", [*HEADLINE, "--chunk_windows", "2"])):
        opt = eval_options(args)
        forward = engine.depth_window_forward(engine.build_depth_model(opt, device))

        def run():
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")

    flash_rows = check_flash(device)
    flash_grad_err = check_flash_grad(device)
    temporal_rows = check_temporal(device)
    mlp_rows = check_fused_mlp(device)
    int8_row = check_int8(device)
    warp_rows = check_warps(device)
    splat_row = check_splat(device)
    model_err = max(check_whole_model(device),
                    check_whole_model(device, ["--encoder", "vitl", "--merge_lora",
                                               "--disable_residual_block"], (112, 140), 4))

    sequences = synthetic_sequences()
    runs = [run_main_path(VITL_ARGS, sequences[:1], device),
            run_main_path([*HEADLINE, "--chunk_windows", "2"], sequences, device),
            run_main_path([*HEADLINE, "--chunk_windows", "2"], sequences, device,
                          env={"ENDODAV_FUSED_MLP": "1"}),
            run_main_path([], sequences, device)]
    for r in runs:
        print(f"[main path] {r['name']}: {r['ms_per_frame']:.3f} ms/frame ({card})")
    args = sys.argv[1:]
    if "--profile-serving" in args:
        profile_serving(device, sequences[0], args[args.index("--profile-serving") + 1])

    with tempfile.TemporaryDirectory(prefix="scared_synth_", dir=os.getcwd()) as root:
        t0 = time.perf_counter()
        write_scared_tree(root)
        print(f"[train] synthetic SCARED tree written in {time.perf_counter() - t0:.1f} s")
        check_small_step(device, root)
        trace_dir = args[args.index("--profile-step") + 1] if "--profile-step" in args else None
        train = run_training(device, root, trace_dir=trace_dir)

    def entry(name, source, replaces, launches, max_abs_err, head, shape):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs_err,
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "shape": shape}

    def head_of(rows, shape):
        return next(r for r in rows if r["shape"] == shape and r["dtype"] == "float32")

    def served(name):
        return sum(r["launches"][name] for r in runs)

    f32 = lambda rows: max(r["err"] for r in rows if r["dtype"] == "float32")  # noqa: E731
    block_rows = [r for r in temporal_rows if r["kernel"] == "block"]
    grouped_rows = [r for r in temporal_rows if r["kernel"] == "grouped"]
    colour = next(r for r in warp_rows if r["call"] == "colour synthesis")
    depth = next(r for r in warp_rows if r["call"] == "depth warps")
    trained = train["launches"]
    warp_src, warp_py = "endodav_tpu_torch/csrc/warp.cu", "endodav_tpu/kernels/warp_matmul.py"
    kernels = [
        entry("flash_attention", "endodav_tpu_torch/csrc/flash_attention.cu",
              "endodav_tpu/kernels/flash_attention.py:43",
              served("flash_attention") + trained["flash_attention"],
              max(f32(flash_rows), flash_grad_err),
              head_of(flash_rows, "B=64 N=1703 H=6 Dh=64"), "B=64 N=1703 H=6 Dh=64"),
        entry("fused_temporal_block", "endodav_tpu_torch/csrc/fused_temporal_block.cu",
              "endodav_tpu/kernels/fused_temporal_block.py:76",
              served("fused_temporal_block") + trained["fused_temporal_block"],
              f32(block_rows), head_of(block_rows, "rows=1702 T=32 C=192"),
              "rows=1702 T=32 C=192"),
        entry("fused_temporal_block_grouped", "endodav_tpu_torch/csrc/fused_temporal_block.cu",
              "endodav_tpu/kernels/fused_temporal_block.py:120",
              served("fused_temporal_block_grouped"), f32(grouped_rows),
              head_of(grouped_rows, "rows=1702 T=32 C=1024"), "rows=1702 T=32 C=1024"),
        entry("fused_mlp", "endodav_tpu_torch/csrc/fused_mlp.cu",
              "endodav_tpu/kernels/fused_mlp.py:73", served("fused_mlp"), f32(mlp_rows),
              head_of(mlp_rows, "rows=54496 384->1536->384"), "rows=54496 384->1536->384"),
        entry("grid_sample_fwd", warp_src, f"{warp_py}:327", trained["grid_sample_fwd"],
              max(r["err_out"] for r in warp_rows), colour["fwd"],
              f"colour synthesis, {colour['shape']}"),
        entry("grid_sample_bwd_coord", warp_src, f"{warp_py}:436",
              trained["grid_sample_bwd_coord"],
              max(max(r["err_dfx"], r["err_dfy"]) for r in warp_rows if "err_dimg" not in r),
              colour["bwd"], f"colour synthesis, {colour['shape']}"),
        entry("grid_sample_bwd_fused", warp_src, f"{warp_py}:488",
              trained["grid_sample_bwd_fused"],
              max(max(r["err_dfx"], r["err_dfy"], r["err_dimg"])
                  for r in warp_rows if "err_dimg" in r),
              depth["bwd"], f"depth warps, {depth['shape']}"),
        entry("splat", warp_src, f"{warp_py}:1029", trained["splat"],
              max(splat_row["err_occ"], splat_row["err_dx"], splat_row["err_dy"]), splat_row,
              splat_row["shape"]),
    ]
    print(f"[summary] int8_dense {int8_row['ms']:.3f} ms vs f32 linear "
          f"{int8_row['f32_linear_ms']:.3f} ms at {int8_row['shape']} ({card})")
    print(f"[summary] whole model max |Δdisp| {model_err:.3e}; training "
          f"{train['ms_per_step']:.1f} ms/step, peak {train['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
