"""bf16 against f32 disparity error of the JAX package and of the PyTorch
port, on the CPU, at a chosen kind of weights and model configuration.

    JAX_PLATFORMS=cpu python tools/bf16_reference_error.py \
        [--weights jax-init|jax-init-filled|random-0.1|engine-seed] \
        [--config flagship|cli-default|headline] [--frames T]

Weights: ``jax-init`` is JAX's own init (``PRNGKey(0)``; the motion
modules' proj_out, the LoRA B factors and the ResBottleneck's last norm
start at zero); ``jax-init-filled`` the same with those zero leaves drawn
fan-in scaled from a seed; ``random-0.1`` every leaf normal at scale 0.1;
``engine-seed`` the port's `engine.build_depth_model` at ``--seed 0``
(`engine.init_random_`, merged where the configuration merges), carried
into JAX's tree by the rules of `utils/convert.py`.  Configurations:
``flagship`` (vits dvlora, residual blocks 2/5/8/11, temporal LoRA, 56x70,
as `tests/test_torch_bf16_serving.py`), ``cli-default`` (the CLI's
defaults at 224x280), ``headline`` (vits 518x644 merged without residual
blocks, as `chip_smoke.py`'s headline leg).  JAX runs its TPU route, the
fused temporal block in Pallas interpret mode.  Prints, per disparity
scale, the largest and mean |bf16 - f32| of each package and the port's
bf16 against JAX's, and the range of JAX's f32 disparity.  The headline at
more than a few frames is a full-size forward: run that on a machine with
memory to spare.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

CONFIGS = {
    "flagship": (["--lora_type", "dvlora", "--temporal_lora", "--depth_image_shape", "56", "70",
                  "--residual_block_indexes", "2", "5", "8", "11"], (64, 80)),
    "cli-default": ([], (256, 320)),
    "headline": (["--depth_image_shape", "518", "644", "--merge_lora",
                  "--disable_residual_block"], (512, 640)),
}
# flax layout from the port's torch layout: the inverses of convert.py's
TO_FLAX = {None: lambda v: v, "conv": lambda v: np.transpose(v, (2, 3, 1, 0)),
           "convT": lambda v: np.transpose(v, (2, 3, 1, 0)), "lin": lambda v: v.T}


@contextlib.contextmanager
def pallas_interpret():
    real = pl.pallas_call
    pl.pallas_call = lambda *a, **k: real(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        pl.pallas_call = real


def to_flax(model) -> dict:
    """The port model's parameters as JAX's param tree."""
    from endodav_tpu_torch.utils.convert import endodav_rules

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = {}
    for torch_key, flax_key, layout in endodav_rules():
        if torch_key in sd:
            node = params
            for k in flax_key[:-1]:
                node = node.setdefault(k, {})
            node[flax_key[-1]] = jnp.asarray(TO_FLAX[layout](sd[torch_key]))
    return params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", default="jax-init",
                    choices=["jax-init", "jax-init-filled", "random-0.1", "engine-seed"])
    ap.add_argument("--config", default="flagship", choices=sorted(CONFIGS))
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()

    from endodav_tpu.models import motion as jmotion
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.utils.convert import from_jax_params

    jmotion._use_fused_block = lambda pos, dim: pos == "ape"  # the TPU serving route
    flags, src_hw = CONFIGS[args.config]
    opt = EndoDAVOptions().parse(["--no_cuda", "--seed", "0", *flags])
    model = engine.build_depth_model(opt, torch.device("cpu"))
    cfg = dict(encoder=opt.encoder, lora_type=model.lora_type, image_shape=model.image_shape,
               residual_block_indexes=([] if opt.disable_residual_block
                                       else opt.residual_block_indexes),
               temporal_lora=opt.temporal_lora and model.lora_type != "none")
    video = np.random.default_rng(7).uniform(0.05, 0.95, (1, args.frames, *src_hw, 3))
    video = video.astype(np.float32)
    if args.weights == "engine-seed":
        params = to_flax(model)
    else:
        jm = JEndoDAV(**cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video))["params"]
        rng = np.random.default_rng(1)
        if args.weights == "random-0.1":
            params = jax.tree_util.tree_map(
                lambda a: (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32), params)
        elif args.weights == "jax-init-filled":
            def fill(path, a):
                a = np.asarray(a)
                if path[-1].key == "bias" or not np.all(a == 0):
                    return a
                scale = np.prod(a.shape[:-1]) ** -0.5 if a.ndim > 1 else 0.02
                return (rng.standard_normal(a.shape) * scale).astype(np.float32)
            params = jax.tree_util.tree_map_with_path(fill, params)
        model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    out = {}
    with pallas_interpret():
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            jm = JEndoDAV(**cfg, dtype=dt)
            out[name] = jax.jit(lambda p, x, jm=jm: jm.apply({"params": p}, x))(
                params, jnp.asarray(video))
    with torch.inference_mode():
        p32 = model(torch.from_numpy(video))
        p16 = model.clone(dtype=torch.bfloat16)(torch.from_numpy(video))

    def err(a, b):
        d = np.abs(a - b)
        return f"max {d.max():.3e} mean {d.mean():.3e}"

    print(f"weights {args.weights}, config {args.config}, {args.frames} frames")
    for s in range(4):
        j32 = np.asarray(out["f32"][("disp", s)])
        j16 = np.asarray(out["bf16"][("disp", s)].astype(jnp.float32))
        q32, q16 = p32[("disp", s)].numpy(), p16[("disp", s)].float().numpy()
        print(f"scale {s}: JAX bf16-f32 {err(j16, j32)} | port bf16-f32 {err(q16, q32)} | "
              f"port bf16 - JAX bf16 {err(q16, j16)} | port f32 - JAX f32 "
              f"{np.abs(q32 - j32).max():.1e} | JAX f32 disparity {j32.min():.4f}-"
              f"{j32.max():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
