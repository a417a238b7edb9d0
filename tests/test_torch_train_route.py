"""The depth model's route in the training step against the JAX package on
the CPU.

JAX's `train/losses.py:_apply` (:70-77) passes ``train`` only to a model
with BatchNorm statistics; EndoDAV, and EndoDAC without ``use_bn``, run
with their default ``train=False``, so on the hardware JAX routes for
(`models/motion.py:_use_fused_block`: APE) the training forward takes the
fused temporal block, LayerNorm eps 1e-5, whose backward recomputes the
plain version.  The port's `main_phase` calls the depth model the same way
(`train/losses.py:depth_train_mode`).

* `depth_train_mode` for each depth model, with and without ``train``;
* the depth model of the port's default main phase receives
  ``train=False``;
* at `tests/test_torch_train_step.py`'s tiny configuration, JAX's main
  phase with `_use_fused_block` patched to ``pos == "ape"`` and its Pallas
  calls in the interpreter against the port's default one: every loss term
  within 1e-4 relative, the gradients of the motion modules' parameters
  within 1e-3 of their largest entry.  The motion modules' weights come
  from a numpy seed (JAX's init zeroes proj_out, which hides the route),
  and their proj_in is scaled by 1e-3, so that the first LayerNorm's input
  variance sits near its eps and the unfused route's eps 1e-6 misses by
  far more than the tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from endodav_tpu_torch.utils.convert import _FORWARD, jax_paths
from test_torch_lora_models import _weights, tpu_route
from test_torch_train_step import (GRAD_RTOL, LOSS_RTOL, _assert_close_rel, _jax_opt, _loss_cfg,
                                   _port_trainer, _with_motion, make_batch)

torch.set_num_threads(1)

PROJ_IN_SCALE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def exact_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _motion_from_seed(variables, seed=11):
    """The depth model's motion-module parameters from ``seed``, proj_in
    scaled by PROJ_IN_SCALE; everything else as given."""
    params = jax.tree_util.tree_map(np.asarray, variables["depth_model"]["params"])
    head = dict(params["head"])
    assert any(k.startswith("motion_modules") for k in head)
    for name in sorted(k for k in head if k.startswith("motion_modules")):
        mm = _weights(head[name], seed)
        seed += 1
        mm = jax.tree_util.tree_map_with_path(
            lambda p, a: a * PROJ_IN_SCALE if "'proj_in'" in jax.tree_util.keystr(p)
            and "'ff'" not in jax.tree_util.keystr(p) else a, mm)
        head[name] = mm
    depth = dict(variables["depth_model"], params=dict(params, head=head))
    return dict(variables, depth_model=depth)


@pytest.mark.parametrize("kind,train,want", [
    ("endodav", True, False), ("endodac", True, False), ("endodac_bn", True, True),
    ("afsfm", True, True), ("endodac_bn", False, False)])
def test_depth_train_mode_follows_jax_apply(kind, train, want):
    from endodav_tpu_torch.models.afsfm import AFSfMDepth
    from endodav_tpu_torch.models.endodac import EndoDAC
    from endodav_tpu_torch.models.endodav import EndoDAV
    from endodav_tpu_torch.train.losses import depth_train_mode

    model = {"endodav": lambda: EndoDAV(image_shape=(28, 42)),
             "endodac": lambda: EndoDAC(image_shape=(28, 42)),
             "endodac_bn": lambda: EndoDAC(image_shape=(28, 42), use_bn=True),
             "afsfm": lambda: AFSfMDepth(18, (0, 1, 2, 3))}[kind]()
    assert depth_train_mode(model, train) is want


@pytest.fixture(scope="module")
def route_setup(exact_cpu_convs):
    from endodav_tpu.train.trainer import _flatten_bt, build_models, init_variables

    jopt = _jax_opt()
    mods = build_models(jopt)
    variables = _motion_from_seed(_with_motion(init_variables(mods, jopt)))
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in _flatten_bt(batch).items()}
    port = _port_trainer(variables)
    return mods, variables, jbatch, port, port.device_batch(batch)


def test_main_phase_runs_the_depth_model_as_jax(route_setup):
    """The port's default main phase (cfg["train"] True) calls EndoDAV with
    ``train=False``; the pose encoder keeps ``train=True``."""
    from endodav_tpu_torch.train import losses as TL

    _, _, _, port, tbatch = route_setup
    seen = {}
    hooks = [port.mods[k].register_forward_pre_hook(
        lambda m, a, kw, k=k: seen.setdefault(k, []).append(kw.get("train", a[-1])),
        with_kwargs=True) for k in ("depth_model", "pose_encoder")]
    try:
        with torch.no_grad():
            TL.main_phase(port.mods, tbatch, _loss_cfg())
    finally:
        for h in hooks:
            h.remove()
        for m in port.mods.values():
            for bn in m.modules():
                if hasattr(bn, "pending"):
                    bn.pending = None
    assert seen["depth_model"] == [False]
    assert seen["pose_encoder"] == [True, True]


def test_main_phase_matches_jax_fused_route(route_setup):
    from endodav_tpu.train import losses as JL
    from endodav_tpu_torch.train import losses as TL

    mods, variables, jbatch, port, tbatch = route_setup
    cfg = _loss_cfg()

    def loss_of(depth_params):
        v = dict(variables, depth_model=dict(variables["depth_model"], params=depth_params))
        loss, aux = JL.main_phase(mods, v, jbatch, cfg)
        return loss, aux["losses"]

    with tpu_route():
        jgrad, jlosses = jax.jit(jax.grad(loss_of, has_aux=True))(
            variables["depth_model"]["params"])
    for comp, m in port.mods.items():
        for p in m.parameters():
            p.requires_grad_(comp == "depth_model")
            p.grad = None
    tloss, aux = TL.main_phase(port.mods, tbatch, cfg)
    tloss.backward()
    for m in port.mods.values():
        for bn in m.modules():
            if hasattr(bn, "pending"):
                bn.pending = None
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    paths = jax_paths("endodav")
    checked = 0
    for name, p in port.mods["depth_model"].named_parameters():
        if "motion_modules" not in name:
            continue
        layout, path = paths[name]
        want = jgrad
        for part in path[1:]:
            want = want[part]
        assert p.grad is not None, name
        _assert_close_rel(_FORWARD[layout](p.grad.numpy()), want, GRAD_RTOL)
        checked += 1
    assert checked > 100
