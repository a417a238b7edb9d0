"""bf16 training (``--compute_dtype bfloat16``) of the port against the JAX
package on the CPU, at the tiny configuration of
`tests/test_torch_train_step.py` (32x64 frames, B=2, T=2, ViT input 28x42),
with JAX's init converted into the port (`utils/checkpoint.load_variables`):

* EndoDAV with `scripts/train_video.sh`'s ssb model flags, and EndoDAC
  (vits, dvlora): the dtype of every output of `main_phase` and of each
  component's output as JAX's; the total loss, each term and the
  disparities against JAX's bf16 `main_phase`, and phase 0's loss against
  JAX's bf16 `position_phase_loss`;
* `rigid_flow` and `berhu`, the last geometry functions of the trainer,
  at f32 and bf16.

JAX runs its warps on their TPU route, the Pallas kernels in interpret
mode: they compute in f32 whatever the image's and coordinates' dtypes, as
the port's CUDA kernels and their plain versions do.  (JAX's CPU route
gathers and blends a bf16 flow's corner weights in bf16, which moves its
bf16 loss 7e-3 away from its own TPU route's at this configuration.)

Tolerances: the total loss within relative 2e-3 of JAX's bf16 loss.  Each
term within twice JAX's own bf16-vs-f32 gap for that term, as a share of
its value, the gap taken as the largest of the term's four scales: at one
scale JAX's gap can cancel by chance (its depth-reprojection term at
scale 0 moves 8e-4 of its value, at scale 3 1.2e-2; the port's moves
8e-3 and 1.1e-2), while every term computed from the bf16 depths moves
by up to a few per cent between any two bf16 computations (one bf16 ulp
of a disparity near 0.5 is 4e-3 of it, and the depth is its inverse).
The bf16 disparities within the bounds of `tests/test_torch_bf16_serving.py`,
2.5e-2 max and 4e-3 mean (measured 1.2e-2 and 1.1e-3; JAX's own bf16
against its f32: 1.6e-2 and 1.4e-3).
"""

import ast
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_step import (FLAGS, H, SCALES, W, _jax_opt, _loss_cfg, _with_motion,
                                   make_batch)

torch.set_num_threads(1)

BF16 = torch.bfloat16
LOSS_RTOL = 2e-3
DISP_MAX, DISP_MEAN = 2.5e-2, 4e-3
# scripts/train_video.sh's model flags (ssb, no residual blocks, no conv head)
SSB_FLAGS = ["--lora_type", "ssb", "--disable_residual_block", "--disable_conv_head",
             "--temporal_lora"]
CONFIGS = {
    "endodav_ssb": ("endodav", SSB_FLAGS),
    "endodac": ("endodac", ["--lora_type", "dvlora"]),
}


@contextlib.contextmanager
def tpu_warps():
    """JAX's warps and splat on their TPU route (`ops/sampling.py:
    _use_mm_kernel` without its backend test), every `pl.pallas_call` in
    Pallas's interpreter."""
    from jax.experimental import pallas as pl

    from endodav_tpu.ops import sampling as jsamp

    real_call, real_use = pl.pallas_call, jsamp._use_mm_kernel
    pl.pallas_call = lambda *a, **k: real_call(*a, **{**k, "interpret": True})
    jsamp._use_mm_kernel = lambda h, w, c: (c <= 4 and h >= 8 and w >= 8
                                            and h * w * c * 4 <= 4 * 1024 * 1024)
    try:
        yield
    finally:
        pl.pallas_call, jsamp._use_mm_kernel = real_call, real_use


def _jax_opt_of(model_type, flags):
    jopt = _jax_opt()
    jopt.model_type = model_type
    jopt.lora_type = flags[flags.index("--lora_type") + 1]
    jopt.disable_residual_block = "--disable_residual_block" in flags
    jopt.disable_conv_head = "--disable_conv_head" in flags
    jopt.temporal_lora = "--temporal_lora" in flags
    return jopt


def _port(model_type, flags, dtype, variables):
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import load_variables

    t = Trainer(EndoDAVOptions().parse([*FLAGS, "--model_type", model_type, *flags,
                                        "--compute_dtype", dtype]))
    for comp, module in t.mods.items():
        load_variables(comp, module, jax.tree_util.tree_map(np.asarray, variables[comp]))
    return t


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    """JAX's f32 and bf16 `main_phase` (losses, outputs' dtypes, scale-0..3
    disparities) and the port's bf16 trainer, on JAX's init with motion."""
    from endodav_tpu.train import losses as JL
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables

    model_type, flags = CONFIGS[request.param]
    jopt = _jax_opt_of(model_type, flags)
    variables = _with_motion(init_variables(build_models(jopt), jopt))
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    cfg = _loss_cfg()
    want = {}
    with tpu_warps():
        for dtype in ("float32", "bfloat16"):
            jopt.compute_dtype = dtype
            mods = build_models(jopt)

            def run(v, mods=mods):
                # string keys: tuple keys of mixed types do not sort as pytree keys
                _, aux = JL.main_phase(mods, v, jbatch, cfg)
                return aux["losses"], {repr(k): o for k, o in aux["outputs"].items()}

            def run0(v, mods=mods):
                out, _ = JL.forward_flow_nets(mods, v, jbatch, SCALES, (H, W), True, False)
                return JL.position_phase_loss(out, jbatch, SCALES, cfg["position_smoothness"])

            losses, outputs = jax.jit(run)(variables)
            want[dtype] = losses, {ast.literal_eval(k): o for k, o in outputs.items()}
            want[f"loss_0 {dtype}"] = float(jax.jit(run0)(variables))
            if dtype == "bfloat16":
                want["mods"] = mods
    with torch.backends.mkldnn.flags(enabled=False):
        port = _port(model_type, flags, "bfloat16", variables)
        tbatch = port.device_batch(batch)
    return want, variables, port, tbatch, cfg


def _port_main(port, tbatch, cfg):
    from endodav_tpu_torch.train import losses as TL

    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        return TL.main_phase(port.mods, tbatch, cfg)[1]


def test_bf16_output_dtypes_match_jax(both):
    """Every output of `main_phase` in JAX's dtype (the flow-consistency map,
    which no loss reads, is JAX's alone), and each component's output: the
    ResNet maps f32 (flax's BatchNorm promotes), the flow, transform, pose
    and intrinsics nets' bf16, the depth model's bf16."""
    want, variables, port, tbatch, cfg = both
    jlosses, jout = want["bfloat16"]
    aux = _port_main(port, tbatch, cfg)
    tout = aux["outputs"]
    assert set(jout) - set(tout) == {k for k in jout if k[0] == "occu_map_bidirection"}
    got = {k: str(v.dtype).replace("torch.", "") for k, v in tout.items()}
    assert got == {k: str(v.dtype) for k, v in jout.items() if k in tout}
    assert ({k: str(v.dtype).replace("torch.", "") for k, v in aux["losses"].items()}
            == {k: str(v.dtype) for k, v in jlosses.items()})

    jm = want["mods"]
    x = np.random.default_rng(5).uniform(0, 1, (2, 32, 64, 6)).astype(np.float32)
    jfeats = jm["pose_encoder"].apply(variables["pose_encoder"], jnp.asarray(x), train=False)
    jpose = jm["pose"].apply(variables["pose"], [jfeats[-1]])
    stages = {
        "features": [a.dtype for a in jfeats],
        "position": [a.dtype for a in jm["position"].apply(variables["position"],
                                                          jfeats).values()],
        "transform": [a.dtype for a in jm["transform"].apply(variables["transform"],
                                                            jfeats).values()],
        "pose": [a.dtype for a in jpose],
        "K": [jm["intrinsics_head"].apply(variables["intrinsics_head"], jpose[2], 64, 32).dtype],
    }
    m = port.mods
    with torch.no_grad():
        feats = m["pose_encoder"](torch.from_numpy(x), False)
        pose = m["pose"]([feats[-1]])
        got = {
            "features": [a.dtype for a in feats],
            "position": [a.dtype for a in m["position"](feats).values()],
            "transform": [a.dtype for a in m["transform"](feats).values()],
            "pose": [a.dtype for a in pose],
            "K": [m["intrinsics_head"](pose[2], 64, 32).dtype],
        }
    as_str = lambda d: {k: [str(t).replace("torch.", "") for t in v]  # noqa: E731
                        for k, v in d.items()}
    assert as_str(got) == as_str(stages)


def test_bf16_losses_match_jax(both):
    """The total loss within 2e-3 of JAX's bf16 loss; each term within twice
    JAX's largest relative bf16-vs-f32 gap over the term's four scales."""
    want, _, port, tbatch, cfg = both
    j32, j16 = want["float32"][0], want["bfloat16"][0]
    got = {k: float(v) for k, v in _port_main(port, tbatch, cfg)["losses"].items()}
    assert set(got) == set(j16)
    np.testing.assert_allclose(got["loss"], float(j16["loss"]), rtol=LOSS_RTOL)
    family = lambda k: k.rsplit("/", 1)[0]  # noqa: E731
    gaps = {}
    for k, v in j16.items():
        rel = abs(float(v) - float(j32[k])) / abs(float(v))
        gaps[family(k)] = max(gaps.get(family(k), 0.0), rel)
    for k, v in j16.items():
        if k == "loss":
            continue
        bound = 2 * gaps[family(k)] * abs(float(v))
        assert abs(got[k] - float(v)) <= bound, (k, got[k], float(v), float(j32[k]))


def test_bf16_position_phase_matches_jax(both):
    """Phase 0's loss (the position nets, bf16 flows warping f32 frames)
    within 2e-3 of JAX's bf16 loss (measured 1.3e-5; JAX's own bf16 is
    1.1e-3 from its f32)."""
    from endodav_tpu_torch.train import losses as TL

    want, _, port, tbatch, cfg = both
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        out = TL.forward_flow_nets(port.mods, tbatch, SCALES, (H, W), True, False)
        got = TL.position_phase_loss(out, tbatch, SCALES, cfg["position_smoothness"])
    for m in port.mods["position_encoder"].modules():
        if hasattr(m, "pending"):
            m.pending = None
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want["loss_0 bfloat16"], rtol=LOSS_RTOL)


def test_bf16_disparities_match_jax(both):
    """The depth model's bf16 disparities at every scale against JAX's,
    within 2.5e-2 max and 4e-3 mean (the bf16 serving bounds), and the loss-side
    depths in bf16."""
    want, _, port, tbatch, cfg = both
    jout = want["bfloat16"][1]
    tout = _port_main(port, tbatch, cfg)["outputs"]
    for s in range(4):
        got = tout[("disp", s)].float().numpy()
        ref = np.asarray(jout[("disp", s)], np.float32)
        assert got.shape == ref.shape
        err = np.abs(got - ref)
        assert err.max() <= DISP_MAX and err.mean() <= DISP_MEAN, (s, err.max(), err.mean())
        assert tout[("depth", 0, s)].dtype == BF16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rigid_flow_matches_jax(dtype):
    """`rigid_flow` (JAX transforms.py:127) on bf16 or f32 points from a
    bf16 or f32 depth, f32 intrinsics and pose: JAX's dtype and values."""
    from endodav_tpu.geometry import transforms as JT
    from endodav_tpu_torch.geometry import transforms as TT

    rng = np.random.default_rng(11)
    b, h, w = 2, 8, 12
    depth = rng.uniform(1, 10, (b, h, w, 1)).astype(np.float32)
    K = np.tile(np.array([[10, 0, 6, 0], [0, 9, 4, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32), (b, 1, 1))
    pose = rng.normal(0, 0.05, (b, 6)).astype(np.float32)
    jd, td = jnp.asarray(depth, dtype), torch.from_numpy(depth).to(getattr(torch, dtype))
    jT = JT.transformation_from_parameters(jnp.asarray(pose[:, :3]), jnp.asarray(pose[:, 3:]))
    tT = TT.transformation_from_parameters(torch.from_numpy(pose[:, :3]),
                                           torch.from_numpy(pose[:, 3:]))
    jinv = jnp.linalg.inv(jnp.asarray(K))
    want = JT.rigid_flow(JT.backproject_depth(jd, jinv), jnp.asarray(K), jT, h, w)
    got = TT.rigid_flow(TT.backproject_depth(td, torch.from_numpy(np.asarray(jinv))),
                        torch.from_numpy(K), tT, h, w)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_berhu_matches_jax(dtype):
    """`berhu` (JAX losses.py:110): value, dtype and gradient."""
    from endodav_tpu.geometry import losses as JG
    from endodav_tpu_torch.geometry import losses as TG

    rng = np.random.default_rng(12)
    pred, target = (rng.normal(0, 1, (2, 8, 12, 1)).astype(np.float32) for _ in range(2))
    jd = getattr(jnp, dtype)
    want, jgrad = jax.value_and_grad(lambda p: JG.berhu(p, jnp.asarray(target, jd)))(
        jnp.asarray(pred, jd))
    tp = torch.from_numpy(pred).to(getattr(torch, dtype)).requires_grad_(True)
    got = TG.berhu(tp, torch.from_numpy(target).to(tp.dtype))
    got.backward()
    assert got.dtype == tp.dtype and str(tp.grad.dtype).replace("torch.", "") == str(jgrad.dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(float(got), float(want), rtol=tol)
    np.testing.assert_allclose(tp.grad.float().numpy(), np.asarray(jgrad, np.float32),
                               rtol=tol, atol=tol * 1e-2)
