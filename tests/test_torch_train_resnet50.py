"""The training path at ``--num_layers 50`` against the JAX package on the
CPU.

* The position encoder as the trainer builds it (ResNet-50 on a stacked
  frame pair): the gradient of every parameter, from a seeded cotangent on
  each of the five maps, against JAX in float64; one update of every
  parameter, the port's `GatedAdam` on its own gradients against JAX's
  `gated_adam_update` on JAX's; the BatchNorm statistics a train-mode pass
  commits.
* The whole step's losses (`slow`: JAX's init and jit of three ResNet-50
  encoders and the ViT take minutes on one core), at the tiny
  configuration of `tests/test_torch_train_step.py` (32x64 frames, B=2,
  T=2, ViT input 28x42), JAX's init converted into the port:
  `position_phase_loss` and every term of `main_phase`'s loss dict.

Tolerances.  The encoder's gradients in eval mode, where each BatchNorm
is affine, against float64: 1e-4 of each parameter's largest entry, as
the phase-0 gradients of `tests/test_torch_train_step.py` (the train-mode
BatchNorm backward is the module ResNet-18 trains with, held there; in
train mode at these sizes a BatchNorm of layer4 takes its spread over 8
values a channel, and both packages' f32 gradients of a few deep
parameters sit up to 30% from float64: measured here).  Updates within
1e-3 of their largest entry where the gradient is above 0.1 of its
largest (Adam's first step is lr * g / (|g| + eps): a gradient far below
its largest may round to either side of its tiny update).  The committed
train-mode statistics within 1e-3 of their largest entry against float64
(`test_torch_resnet_deep.py`).  The whole step's losses relative 1e-4, as
`tests/test_torch_train_step.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_endodac import KEY, _fan_in
from test_torch_train_step import (FLAGS, GRAD64_RTOL, GRAD_RTOL, H, LOSS_RTOL, SCALES, W,
                                   _assert_close_rel, _jax_opt, _loss_cfg, _port_trainer,
                                   _with_motion, make_batch)

from endodav_tpu_torch.utils.convert import _INVERSE, resnet_encoder_rules

torch.set_num_threads(1)

NUM_LAYERS = 50
STATS64_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_resnet50_gradients_and_update_match_jax():
    """The trainer's position encoder at ResNet-50 (`build_models`), from a
    seeded cotangent on its five maps: the gradient of every parameter in
    eval mode against JAX in float64, and one Adam update of them, the
    port's `GatedAdam` on its own gradients against JAX's
    `gated_adam_update` on JAX's; then a train-mode pass's committed
    statistics against JAX's in float64."""
    from flax.traverse_util import flatten_dict

    from endodav_tpu.models.resnet import ResNetEncoder as JResNet
    from endodav_tpu.train import optim as JO
    from endodav_tpu_torch.models.resnet import commit_batch_stats
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.optim import GatedAdam
    from endodav_tpu_torch.train.trainer import build_models
    from endodav_tpu_torch.utils.convert import from_jax_params

    rng = np.random.default_rng(50)
    x = rng.uniform(0, 1, (2, 64, 64, 6)).astype(np.float32)
    jm = JResNet(NUM_LAYERS, num_input_images=2)
    var = _fan_in(jax.eval_shape(jm.init, KEY, jnp.asarray(x)), seed=52)
    tm = build_models(EndoDAVOptions().parse([*FLAGS, "--num_layers", str(NUM_LAYERS)]))[
        "position_encoder"]
    tm.load_state_dict(from_jax_params(var["params"], "resnet_encoder", var["batch_stats"]),
                       strict=True)
    shapes = [m.shape for m in jax.eval_shape(jm.apply, var, jnp.asarray(x))]
    cot = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    with jax.enable_x64(True):
        jm64, stats64 = jm.clone(dtype=jnp.float64), _f64(var["batch_stats"])

        def loss(params):
            maps = jm64.apply({"params": params, "batch_stats": stats64}, _f64(x), train=False)
            return sum(jnp.vdot(m, _f64(c)) for m, c in zip(maps, cot))

        grads = jax.jit(jax.grad(loss))(_f64(var["params"]))
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
        stats = jm64.apply({"params": _f64(var["params"]), "batch_stats": stats64}, _f64(x),
                           train=True, mutable=["batch_stats"])[1]["batch_stats"]
        stats = jax.tree_util.tree_map(np.asarray, stats)
    new = JO.gated_adam_update(grads, JO.init_adam(var["params"]), var["params"], 1e-4)[0]

    maps = tm(torch.from_numpy(x), train=False)
    sum((m * torch.from_numpy(c)).sum() for m, c in zip(maps, cot)).backward()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    GatedAdam({"position_encoder": tm}).step(1e-4)

    paths = {t: (f, layout) for t, f, layout in resnet_encoder_rules()}
    fg, fnew = flatten_dict(grads), flatten_dict(new)
    for name, prm in tm.named_parameters():
        f, layout = paths[name]
        g = _INVERSE[layout](fg[f])
        _assert_close_rel(prm.grad, g, GRAD64_RTOL)
        want = _INVERSE[layout](np.asarray(fnew[f])) - before[name].numpy()
        got = (prm.detach() - before[name]).numpy()
        sure = np.abs(g) > 0.1 * np.abs(g).max()
        assert want[sure].any(), name
        _assert_close_rel(got[sure], want[sure], GRAD_RTOL)
    assert len(before) == 16 * 9 + 4 * 3 + 3  # the blocks, their projections, the stem

    with torch.no_grad():
        for prm in tm.parameters():  # back to the weights JAX's pass ran on
            prm.copy_(before[next(n for n, p in tm.named_parameters() if p is prm)])
        tm(torch.from_numpy(x), train=True)
    commit_batch_stats(tm)
    fstats = flatten_dict(stats)
    bufs = dict(tm.named_buffers())
    assert len(bufs) == len(fstats)
    for name, buf in bufs.items():
        _assert_close_rel(buf, fstats[paths[name][0][1:]], STATS64_RTOL)


@pytest.fixture(scope="module")
def setup(exact_cpu_convs):
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables

    jopt = _jax_opt()
    jopt.num_layers = NUM_LAYERS
    mods = build_models(jopt)
    variables = _with_motion(init_variables(mods, jopt))
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    port = _port_trainer(variables, num_layers=NUM_LAYERS)
    assert port.mods["pose"].convs["squeeze"].in_channels == 2048
    return mods, variables, jbatch, port, port.device_batch(batch)


@pytest.mark.slow
def test_position_phase_loss_matches_jax(setup):
    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.train import losses as TL

    mods, variables, jbatch, port, tbatch = setup

    def loss0(v):
        out, _ = JL.forward_flow_nets(mods, v, jbatch, SCALES, (H, W), True, False)
        return JL.position_phase_loss(out, jbatch, SCALES, 1e-3, True)

    jl = jax.jit(loss0)(variables)
    with torch.no_grad():
        out = TL.forward_flow_nets(port.mods, tbatch, SCALES, (H, W), True, False)
        tl = TL.position_phase_loss(out, tbatch, SCALES, 1e-3, True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for m in port.mods["position_encoder"].modules():
        if hasattr(m, "pending"):
            m.pending = None


@pytest.mark.slow
def test_main_phase_losses_match_jax(setup):
    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.train import losses as TL

    mods, variables, jbatch, port, tbatch = setup
    cfg = _loss_cfg()
    jlosses = jax.jit(lambda v: JL.main_phase(mods, v, jbatch, cfg)[1]["losses"])(variables)
    with torch.no_grad():
        _, aux = TL.main_phase(port.mods, tbatch, cfg)
    assert set(aux["losses"]) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for m in port.mods.values():
        for bn in m.modules():
            if hasattr(bn, "pending"):
                bn.pending = None
