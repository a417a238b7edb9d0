"""bf16 against f32 training losses of the JAX package and of the PyTorch
port, on the CPU, against the frame size.

    JAX_PLATFORMS=cpu python tools/bf16_train_gap.py [--height 64] [--width 320]

One clip (B=1, T=2) of textured frames drifting 4 px right and 3 px down a
frame (the recipe of `chip_smoke.py:write_scared_tree`), at
`scripts/train_video.sh`'s ssb model flags with the ViT at 28x42, JAX's
init weights (PRNGKey 314) carried into the port by the rules of
`utils/convert.py`.  JAX runs its warps on their TPU route, the Pallas
kernels in interpret mode (f32 inside, as the port's CUDA kernels).
Prints phase 0's loss (`position_phase_loss`) and the main phase's
(`main_phase`) of each package at float32 and bfloat16, and each
package's relative bf16-vs-f32 gap.  Both packages build the pixel grids
of the warps in the flow's dtype, so in bf16 a grid coordinate past x =
256 steps by 2 px: the gap grows with the width.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

SCALES = (0, 1, 2, 3)
MODEL = dict(lora_type="ssb", disable_residual_block=True, disable_conv_head=True,
             temporal_lora=True)


@contextlib.contextmanager
def tpu_warps():
    from endodav_tpu.ops import sampling as jsamp

    real_call, real_use = pl.pallas_call, jsamp._use_mm_kernel
    pl.pallas_call = lambda *a, **k: real_call(*a, **{**k, "interpret": True})
    jsamp._use_mm_kernel = lambda h, w, c: (c <= 4 and h >= 8 and w >= 8
                                            and h * w * c * 4 <= 4 * 1024 * 1024)
    try:
        yield
    finally:
        pl.pallas_call, jsamp._use_mm_kernel = real_call, real_use


def jax_opt(h, w, b, t, dtype):
    return types.SimpleNamespace(
        encoder="vits", pre_norm=False, inv_sigmoid=False, out_sigmoid=False, lora_rank=4,
        residual_block_indexes=[], include_cls_token=True, model_type="endodav",
        num_layers=18, height=h, width=w, scales=list(SCALES), batch_size=b, T=t,
        compute_dtype=dtype, depth_image_shape=(28, 42), predictive_mask=False, **MODEL)


def clip_batch(h, w, b=1, t=2, seed=0):
    """Loader-shaped batch [B, T, ...] of drifting textured frames."""
    from endodav_tpu_torch.data.pipeline import scaled_intrinsics

    rng = np.random.default_rng(seed)
    bh, bw = h + 3 * (t + 4), w + 4 * (t + 4)
    yy, xx = np.meshgrid(np.linspace(0, bh / 128, bh), np.linspace(0, bw / 160, bw),
                         indexing="ij")
    tex = np.stack([128 + 70 * np.sin(9 * xx + 5 * yy + c) + 30 * np.cos(23 * yy - 17 * xx)
                    for c in range(3)], -1)
    tex = np.clip(tex + rng.uniform(-12, 12, tex.shape), 0, 255) / 255.0
    batch = {}
    for fi in (0, -1, 1):
        clip = np.stack([[tex[3 * i:3 * i + h, 4 * i:4 * i + w]
                          for i in range(2 + fi, 2 + fi + t)]] * b).astype(np.float32)
        for s in SCALES:
            x = torch.from_numpy(clip.reshape(-1, h, w, 3)).permute(0, 3, 1, 2)
            x = F.interpolate(x, size=(h >> s, w >> s), mode="bilinear", antialias=True,
                              align_corners=False).permute(0, 2, 3, 1).numpy()
            batch[("color", fi, s)] = batch[("color_aug", fi, s)] = x.reshape(
                b, t, *x.shape[1:])
    for s in SCALES:
        K, iK = scaled_intrinsics(w, h, s)
        batch[("K", s)] = np.broadcast_to(K, (b, t, 4, 4)).copy()
        batch[("inv_K", s)] = np.broadcast_to(iK, (b, t, 4, 4)).copy()
    return batch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=320)
    args = ap.parse_args()
    from endodav_tpu.train import losses as JL
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train import losses as TL
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import load_variables

    h, w, b, t = args.height, args.width, 1, 2
    cfg = dict(scales=SCALES, height=h, width=w, T=t, batch_size=b, min_depth=0.1,
               max_depth=150.0, no_ssim=False, learn_intrinsics=True,
               transform_constraint=0.01, transform_smoothness=0.01, disparity_smoothness=1e-3,
               position_smoothness=1e-3, depth_reproj=0.01, depth_flow=0.01, train=True)
    batch = clip_batch(h, w, b, t)
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    variables = init_variables(build_models(jax_opt(h, w, b, t, "float32")),
                               jax_opt(h, w, b, t, "float32"))
    res = {}
    with tpu_warps():
        for dtype in ("float32", "bfloat16"):
            mods = build_models(jax_opt(h, w, b, t, dtype))

            def losses(v, mods=mods):
                out, _ = JL.forward_flow_nets(mods, v, jbatch, SCALES, (h, w), True, False)
                return (JL.position_phase_loss(out, jbatch, SCALES, 1e-3, True),
                        JL.main_phase(mods, v, jbatch, cfg)[0])

            res[f"jax {dtype}"] = [float(x) for x in jax.jit(losses)(variables)]
    flags = ["--no_cuda", "--data_path", "/nonexistent", "--height", str(h), "--width", str(w),
             "--batch_size", str(b), "--T", str(t), "--depth_image_shape", "28", "42",
             "--depth_reproj", "0.01", "--depth_flow", "0.01", "--lora_type", "ssb",
             "--disable_residual_block", "--disable_conv_head", "--temporal_lora"]
    with torch.backends.mkldnn.flags(enabled=False):
        for dtype in ("float32", "bfloat16"):
            tr = Trainer(EndoDAVOptions().parse([*flags, "--compute_dtype", dtype]))
            for comp, module in tr.mods.items():
                load_variables(comp, module, jax.tree_util.tree_map(np.asarray, variables[comp]))
            tb = tr.device_batch(batch)
            with torch.no_grad():
                out = TL.forward_flow_nets(tr.mods, tb, SCALES, (h, w), True, False)
                res[f"port {dtype}"] = [float(TL.position_phase_loss(out, tb, SCALES, 1e-3)),
                                        float(TL.main_phase(tr.mods, tb, cfg)[0])]
    for pkg in ("jax", "port"):
        f32, bf16 = res[f"{pkg} float32"], res[f"{pkg} bfloat16"]
        gap = [abs(x - y) / abs(y) for x, y in zip(bf16, f32)]
        print(f"{pkg} {h}x{w}: phase 0 f32 {f32[0]:.6f} bf16 {bf16[0]:.6f}, main f32 "
              f"{f32[1]:.6f} bf16 {bf16[1]:.6f}; bf16-vs-f32 gap phase 0 {gap[0]:.3e}, "
              f"main {gap[1]:.3e}")


if __name__ == "__main__":
    main()
