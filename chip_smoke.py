#!/usr/bin/env python3
"""Drive the PyTorch port's video-depth serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from `endodav_tpu_torch/csrc/` with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, in f32 and bf16, with both times;
  4. the full-width vits EndoDAV (random weights from a seed) on one
     8-frame 224x280 clip, on the card with the kernels against the CPU
     with the plain versions;
  5. the serving path as the CLI runs it (engine.build_depth_model ->
     depth_window_forward -> evaluate_video_sequences) over two synthetic
     SCARED-like sequences, in the benchmark's headline configuration and
     in the CLI default, with finite metrics and the kernels' launch
     counts checked;
  6. a JSON line per kernel and, last, the device line.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
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
FLASH_SHAPES = [(64, 321), (64, 1703)]  # (B, N): chunk_windows=2 x 32 frames; 224x280, 518x644
TEMPORAL_SHAPES = [(192, 1702), (384, 437), (64, 6808)]  # (C, rows) of one 518x644 window


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def time_pair(kernel, plain, iters: int = 5) -> tuple[float, float]:
    """Mean ms per call of (kernel, plain), run in turns plain, kernel,
    kernel, plain after one warm-up call each."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    kernel(), plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_flash(device, shapes=FLASH_SHAPES, heads=6, dh=64, timing=True):
    from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention

    rows = []
    g = torch.Generator(device=device).manual_seed(SEED)
    for b, n in shapes:
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
                row["ms"], row["plain_ms"] = time_pair(
                    lambda: qkv_attention(x, heads),
                    lambda: attention_reference(*split(), dh ** -0.5))
            print(f"[flash_attention] {row}")
            require(err <= TOL[dtype], f"flash_attention {row}: max |err| above {TOL[dtype]}")
            rows.append(row)
    return rows


def check_temporal(device, shapes=TEMPORAL_SHAPES, t=32, heads=8, timing=True):
    from endodav_tpu_torch.kernels.fused_temporal_block import (fused_temporal_block,
                                                                 reference_block)
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
            want = reference_block(ref_args[0], gamma, beta, pe, *ref_args[1:5], ref_args[5],
                                   heads)
            got = fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads).float()
            torch.cuda.synchronize(device)
            err = (got - want).abs().max().item()
            row = dict(shape=f"rows={nrows} T={t} C={c}", dtype=str(dtype)[6:], err=err)
            if timing:
                row["ms"], row["plain_ms"] = time_pair(
                    lambda: fused_temporal_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads),
                    lambda: reference_block(xd, gamma, beta, pe, wq, wk, wv, wo, bod, heads))
            print(f"[fused_temporal_block] {row}")
            require(err <= TOL[dtype], f"fused_temporal_block {row}: max |err| above {TOL[dtype]}")
            rows.append(row)
    return rows


def eval_options(args):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse(["--seed", str(SEED), *args])


def check_whole_model(device, image_shape=(224, 280), frames=8):
    """Full-width vits on the card (kernels) vs the CPU (plain versions)."""
    from endodav_tpu_torch.eval import engine

    opt = eval_options(["--no_cuda", "--depth_image_shape", *map(str, image_shape)])
    cpu_model = engine.build_depth_model(opt, torch.device("cpu"))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(SEED)
    video = torch.from_numpy(rng.uniform(0.0, 1.0, (1, frames, 256, 320, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu_model(video)
        got = gpu_model(video.to(device))
    errs = {s: (got[("disp", s)].cpu() - want[("disp", s)]).abs().max().item() for s in range(4)}
    print(f"[whole model] vits {image_shape} T={frames}: max |Δdisp| per scale {errs}")
    for s, e in errs.items():
        require(np.isfinite(e) and e <= MODEL_TOL,
                f"whole model scale {s}: max |Δdisp| {e} above {MODEL_TOL}")
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


def run_main_path(args, sequences, device):
    """build_depth_model -> depth_window_forward -> evaluate_video_sequences,
    with the kernels' launch counts read around the run."""
    from endodav_tpu_torch.cli.evaluate_depth_video import report
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import window_indices
    from endodav_tpu_torch.kernels.flash_attention import qkv_attention
    from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block

    opt = eval_options(args)
    forward = engine.depth_window_forward(engine.build_depth_model(opt, device))
    qkv_attention.launches = 0
    fused_temporal_block.launches = 0
    t0 = time.perf_counter()
    result = engine.evaluate_video_sequences(opt, sequences, forward, device=device)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": qkv_attention.launches,
                "fused_temporal_block": fused_temporal_block.launches}
    chunks = sum(-(-len(window_indices(len(s["colors"]))) // opt.chunk_windows)
                 for s in sequences)
    for line in report(result):
        print(f"[main path {' '.join(args) or 'CLI default'}] {line}")
    print(f"[main path] chunks={chunks} launches={launches} wall={wall:.3f} s")
    vals = np.concatenate([result["mean_errors"], result["mean_temporal"]])
    require(bool(np.all(np.isfinite(vals))), f"main path metrics not finite: {vals}")
    require(launches["flash_attention"] == 12 * chunks,
            f"flash_attention launched {launches['flash_attention']} times, "
            f"expected 12 per chunk x {chunks}")
    require(launches["fused_temporal_block"] == 8 * chunks,
            f"fused_temporal_block launched {launches['fused_temporal_block']} times, "
            f"expected 8 per chunk x {chunks}")
    return {"args": args, "ms_per_frame": result["mean_infer_ms"], "launches": launches,
            "chunks": chunks, "metrics": [float(v) for v in vals]}


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
    temporal_rows = check_temporal(device)
    model_err = check_whole_model(device)

    sequences = synthetic_sequences()
    runs = [run_main_path(["--depth_image_shape", "518", "644", "--merge_lora",
                           "--disable_residual_block", "--chunk_windows", "2"], sequences, device),
            run_main_path([], sequences, device)]
    for r in runs:
        print(f"[main path] {' '.join(r['args']) or 'CLI default'}: "
              f"{r['ms_per_frame']:.3f} ms/frame ({card})")

    def summary(name, source, replaces, rows, headline):
        head = next(r for r in rows if r["shape"] == headline and r["dtype"] == "float32")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(r["launches"][name] for r in runs),
                "max_abs_err": max(r["err"] for r in rows if r["dtype"] == "float32"),
                "ms": head["ms"], "plain_ms": head["plain_ms"], "shape": headline}

    kernels = [
        summary("flash_attention", "endodav_tpu_torch/csrc/flash_attention.cu",
                "endodav_tpu/kernels/flash_attention.py:43", flash_rows,
                "B=64 N=1703 H=6 Dh=64"),
        summary("fused_temporal_block", "endodav_tpu_torch/csrc/fused_temporal_block.cu",
                "endodav_tpu/kernels/fused_temporal_block.py:76", temporal_rows,
                "rows=1702 T=32 C=192"),
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
