"""Checkpoints of the port against the JAX package's on the CPU.

* the flax-free msgpack codec (`utils/msgpack.py`) decodes flax's
  ``to_bytes`` of each of the trainer's eight components' init variables
  and of an ``init_adam`` tree to identical arrays (dtype, shape, values)
  and re-encodes them to the same bytes; the port writes those same bytes
  for the same weights (`utils/checkpoint.py`, sorted keys, as a tree out
  of a jit);
* a folder written by JAX's `save_components` loads into the port's
  `Trainer` (``--load_weights_folder`` with every component in
  ``--models_to_load``) and `engine.build_depth_model`: each component's
  output equals JAX's within 1e-5 of max(1, its largest entry);
* the port's `save_model` after one step loads with JAX's
  `load_components` to the port's values bit for bit (the outputs within
  1e-5), and its ``adam.msgpack`` with JAX's `load_pytree`: a trained
  leaf's mu and nu are the port's ``exp_avg`` and ``exp_avg_sq`` in flax's
  layout, count 1; an untrained one zeros, count 0;
* a Dash checkpoint saved in phase 2 serves phase 2 in both engines,
  merged and not, whichever package wrote it (both write the same bytes);
* ``--models_to_load`` loads only the components it names.

The JAX depth model runs its TPU serving route (the fused temporal block in
Pallas's interpreter), as the port serves.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from flax.traverse_util import flatten_dict

from test_torch_train_loop import (ARGS, COMPONENTS, TRAIN_ARGS, both_read,  # noqa: F401
                                   jax_folder, jax_model, jax_opt, port_opt, random_variables,
                                   tpu_route, tree)

torch.set_num_threads(1)

TOL = 1e-5
MAIN = ("depth_model", "transform_encoder", "transform", "pose_encoder", "pose",
        "intrinsics_head")
POSITION = ("position_encoder", "position")


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def jax_init():
    """JAX's eight components and their ``init_variables`` (out of a jit)."""
    from endodav_tpu.train.trainer import build_models, init_variables

    opt = jax_opt("--data_path", "/nonexistent", *TRAIN_ARGS)
    mods = build_models(opt)
    return mods, init_variables(mods, opt)


def _adam_tree(params_of):
    from endodav_tpu.train import optim as JO

    return {"main": JO.init_adam({k: params_of[k] for k in MAIN}),
            "position": JO.init_adam({k: params_of[k] for k in POSITION})}


# ---------------------------------------------------------------- codec


@pytest.mark.parametrize("name", [*COMPONENTS, "adam"])
def test_codec_matches_flax_bytes(jax_init, name):
    """flax bytes -> `unpackb` -> the same arrays -> `packb` -> the same
    bytes; for a component the port's own file of the same weights is
    those bytes too."""
    from endodav_tpu_torch.train.trainer import build_models
    from endodav_tpu_torch.utils import msgpack
    from endodav_tpu_torch.utils.checkpoint import component_variables, load_variables

    mods, init = jax_init
    tree = (_adam_tree({k: v["params"] for k, v in init.items()}) if name == "adam"
            else init[name])
    data = serialization.to_bytes(tree)
    decoded = msgpack.unpackb(data)
    want, got = _flat(tree), _flat(decoded)
    assert list(want) == list(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    assert msgpack.packb(decoded) == data
    if name != "adam":
        module = build_models(port_opt("--data_path", "/nonexistent", *TRAIN_ARGS))[name]
        load_variables(name, module, jax.tree_util.tree_map(np.asarray, init[name]))
        assert msgpack.packb(component_variables(name, module), sort_keys=True) == data


def test_codec_refuses_what_it_cannot_write():
    from endodav_tpu_torch.utils import msgpack

    with pytest.raises(ValueError, match="chunk limit"):
        msgpack.packb({"big": np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), (2 ** 28 + 1,), (0,))})
    with pytest.raises(TypeError):
        msgpack.packb({"x": object()})


# ------------------------------------------------------- JAX -> port


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    feats = [rng.uniform(0, 1, s).astype(np.float32)
             for s in ((2, 32, 48, 64), (2, 16, 24, 64), (2, 8, 12, 128), (2, 4, 6, 256),
                       (2, 2, 3, 512))]
    return {"video": rng.uniform(0, 1, (1, 4, 64, 96, 3)).astype(np.float32),
            "pair": rng.uniform(0, 1, (2, 64, 96, 6)).astype(np.float32),
            "feats": feats, "mid": rng.standard_normal((2, 2, 3, 256)).astype(np.float32)}


def _outputs(name, apply, x):
    """{label: array} of component ``name`` on the inputs ``x``, through
    ``apply(*args)`` (JAX's ``mod.apply(variables, ...)`` or the port's
    module)."""
    if name == "depth_model":
        return {"disp0": apply(x["video"])[("disp", 0)]}
    if name.endswith("encoder"):
        return {f"feat{i}": f for i, f in enumerate(apply(x["pair"]))}
    if name in ("position", "transform"):
        return {str(k): v for k, v in apply(x["feats"]).items()}
    if name == "pose":
        return dict(zip(("axisangle", "translation", "mid"), apply([x["feats"][-1]])))
    return {"K": apply(x["mid"], 96, 64)}


def _jax_outputs(mods, variables, name, x):
    kw = {"train": False} if name.endswith("encoder") else {}
    to_j = lambda a: [jnp.asarray(f) for f in a] if isinstance(a, list) else jnp.asarray(a)  # noqa: E731
    return _outputs(name, lambda a, *r: mods[name].apply(variables[name], to_j(a), *r, **kw), x)


def _port_outputs(module, name, x):
    def apply(a, *r):
        a = [torch.from_numpy(f) for f in a] if isinstance(a, list) else torch.from_numpy(a)
        with torch.inference_mode():
            return module(a, False, *r) if name.endswith("encoder") else module(a, *r)

    return {k: v.numpy() for k, v in _outputs(name, apply, x).items()}


@pytest.fixture(scope="module")
def port_from_jax(jax_folder):
    from endodav_tpu_torch.train.trainer import Trainer

    return Trainer(port_opt("--data_path", "/nonexistent", "--load_weights_folder", jax_folder,
                            "--models_to_load", *COMPONENTS, *TRAIN_ARGS))


@pytest.mark.parametrize("name", COMPONENTS)
def test_jax_checkpoint_trains_in_port(jax_model, port_from_jax, tpu_route, name):
    mods, variables = jax_model
    x = _inputs()
    want = _jax_outputs(mods, variables, name, x)
    got = _port_outputs(port_from_jax.mods[name].eval(), name, x)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], f"{name} {k}")


def test_jax_checkpoint_serves_in_port(jax_model, jax_folder, tpu_route):
    """`engine.build_depth_model` reads JAX's ``depth_model.msgpack``
    (without ``--temporal_lora``, as the shipped eval: the motion modules'
    adapters in the file are left out, as flax leaves them out)."""
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu_torch.eval import engine

    args = ["--load_weights_folder", jax_folder, *ARGS]
    jm, jv = jengine.build_depth_model(jax_opt(*args))
    x = _inputs()
    want = _outputs("depth_model", lambda v: jm.apply(jv, jnp.asarray(v)), x)
    got = _port_outputs(engine.build_depth_model(port_opt(*args)), "depth_model", x)
    _close(got["disp0"], want["disp0"], "served disparity")


# ------------------------------------------------------- port -> JAX


def test_port_checkpoint_loads_in_jax(both_read, jax_model, jax_folder, jax_init, tpu_route,
                                      tmp_path):
    """One port step from JAX's weights, `save_model`, then JAX's
    `load_components` and `load_pytree` on the folder."""
    from endodav_tpu.train import optim as JO
    from endodav_tpu.utils import checkpoint as jckpt
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import component_variables

    t = Trainer(port_opt("--data_path", both_read, "--log_dir", str(tmp_path),
                         "--load_weights_folder", jax_folder, "--models_to_load", *COMPONENTS,
                         *TRAIN_ARGS))
    with torch.backends.mkldnn.flags(enabled=False):
        t.train_one_batch(next(iter(t.train_loader)))
    folder = t.save_model(mode="last")
    mods, init = jax_init
    loaded = jckpt.load_components(folder, jax.tree_util.tree_map(np.asarray, init))
    for name in COMPONENTS:
        want = _flat(component_variables(name, t.mods[name]))
        got = _flat(loaded[name])
        assert list(got) == list(_flat(init[name])), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
    x = _inputs()
    for name in ("depth_model", "pose_encoder", "pose", "intrinsics_head"):
        want = _port_outputs(t.mods[name].eval(), name, x)
        got = _jax_outputs(mods, loaded, name, x)
        for k in want:
            _close(got[k], want[k], f"{name} {k}")

    params = {k: v["params"] for k, v in init.items()}
    adam = jckpt.load_pytree(os.path.join(folder, "adam.msgpack"), _adam_tree(params))
    main = adam["main"]
    depth = dict(t.mods["depth_model"].named_parameters())
    lora_a = depth["pretrained.blocks.5.mlp.fc1.lora_A"]
    st = t.opt_main.state_of(lora_a)
    path = ("pretrained", "blocks_5", "mlp", "fc1", "lora_A")
    leaf = lambda tree: flatten_dict(tree["depth_model"])[path]  # noqa: E731
    np.testing.assert_array_equal(leaf(main["mu"]), st["exp_avg"].numpy())
    np.testing.assert_array_equal(leaf(main["nu"]), st["exp_avg_sq"].numpy())
    assert float(leaf(main["count"])) == float(st["step"]) == 1.0
    pose_w = dict(t.mods["pose"].named_parameters())["convs.pose_2.weight"]
    st = t.opt_main.state_of(pose_w)
    kernel = flatten_dict(main["mu"]["pose"])[("pose_2", "kernel")]
    np.testing.assert_array_equal(kernel, st["exp_avg"].permute(2, 3, 1, 0).numpy())
    frozen = ("pretrained", "blocks_0", "attn", "qkv", "kernel")
    assert not flatten_dict(main["mu"]["depth_model"])[frozen].any()
    assert float(flatten_dict(main["count"]["depth_model"])[frozen]) == 0.0
    pos = flatten_dict(adam["position"]["count"]["position"])
    assert all(float(c) == 1.0 for c in pos.values())


# --------------------------------------------------------------- Dash


@pytest.mark.parametrize("merge", [False, True])
def test_dash_phase_survives_both_ways(tmp_path, tpu_route, merge):
    """A Dash depth model saved in phase 2 (its metadata says so), once by
    JAX and once by the port from the same weights (the same bytes), is
    served by each engine from the other's folder in phase 2, as built and
    merged, within 1e-5; phase 1 serves another disparity."""
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.train.trainer import build_models as jbuild
    from endodav_tpu.utils import checkpoint as jckpt
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.models.lora import dash_phase2_of, set_dash_phase2
    from endodav_tpu_torch.train.trainer import build_models
    from endodav_tpu_torch.utils.checkpoint import load_variables, save_components

    flags = ["--lora_type", "dash", "--depth_image_shape", "28", "42",
             "--disable_residual_block", "--disable_conv_head"]
    jm = jbuild(jax_opt(*flags))["depth_model"]
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 28, 42, 3)))
    variables = random_variables(init, seed=9)
    meta = {"height": 64, "width": 96, "use_stereo": False, "dash_phase2": True}
    by_jax, by_port = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_components(by_jax, {"depth_model": variables}, metadata=meta)
    pm = build_models(port_opt("--data_path", "/nonexistent", *flags))["depth_model"]
    load_variables("depth_model", pm, variables)
    save_components(by_port, {"depth_model": set_dash_phase2(pm, True)}, metadata=meta)
    blob = lambda d: open(os.path.join(d, "depth_model.msgpack"), "rb").read()  # noqa: E731
    assert blob(by_jax) == blob(by_port)

    extra = ["--merge_lora"] if merge else []
    x = _inputs()
    jmodel, jv = jengine.build_depth_model(jax_opt("--load_weights_folder", by_port, *flags,
                                                   *extra))
    want = _outputs("depth_model", lambda v: jmodel.apply(jv, jnp.asarray(v)), x)["disp0"]
    served = engine.build_depth_model(port_opt("--load_weights_folder", by_jax, *flags, *extra))
    assert merge or dash_phase2_of(served)
    got = _port_outputs(served, "depth_model", x)["disp0"]
    _close(got, want, "phase-2 disparity")
    phase1 = _port_outputs(set_dash_phase2(pm.eval(), False), "depth_model", x)["disp0"]
    assert np.abs(phase1 - want).max() > 100 * TOL


# ------------------------------------------------------- models_to_load


def test_models_to_load_loads_only_those_named(tmp_path):
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.checkpoint import save_components

    base = ["--data_path", "/nonexistent", *TRAIN_ARGS]
    source = Trainer(port_opt(*base, "--seed", "1"))
    save_components(str(tmp_path), source.mods)
    fresh = Trainer(port_opt(*base))
    named = ("pose", "intrinsics_head")
    t = Trainer(port_opt(*base, "--load_weights_folder", str(tmp_path), "--models_to_load",
                         *named))
    for name in COMPONENTS:
        ref = (source if name in named else fresh).mods[name].state_dict()
        sd = t.mods[name].state_dict()
        assert all(torch.equal(sd[k], ref[k]) for k in ref), name
    with pytest.raises(ValueError, match="unknown components"):
        Trainer(port_opt(*base, "--load_weights_folder", str(tmp_path), "--models_to_load",
                         "posenet"))
