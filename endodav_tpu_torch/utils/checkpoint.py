"""Checkpoints in the JAX package's layout.

Port of `endodav_tpu/utils/checkpoint.py:40-97`: one flax-msgpack file a
component, ``<folder>/<component>.msgpack``, holding JAX's
``variables[component]`` (``params``, and ``batch_stats`` for the ResNet
encoders) in flax's kernel layouts, with ``depth_model.msgpack.meta.json``
beside the depth model (``height``, ``width``, ``use_stereo``,
``dash_phase2``); the trainer adds ``adam.msgpack``.  Files are written
and read by the port's own codec (`utils/msgpack.py`) through the rule
tables of `utils/convert.py`, so either package reads what the other
wrote.  A component with no ``.msgpack`` but a reference ``<component>.pth``
loads that file (JAX :70-86).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from endodav_tpu_torch.utils import msgpack
from endodav_tpu_torch.utils.convert import (COMPONENT_KIND, from_jax_params, load_reference_pth,
                                              to_jax_params)

__all__ = ["save_pytree", "load_pytree", "load_metadata", "component_kind",
           "component_variables", "load_variables", "save_components", "load_components"]


def save_pytree(path: str, tree, metadata: dict | None = None) -> None:
    """``tree`` (nested dicts of numpy arrays) as msgpack at ``path``, its
    maps in sorted key order, as JAX writes a tree that came out of a jit;
    ``metadata`` as JSON at ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(tree, sort_keys=True))
    if metadata:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def _restore(like, state, path: str):
    """flax's ``from_state_dict`` on dicts: every key of ``like`` must be in
    ``state``; keys only ``state`` has are left out."""
    if not isinstance(like, dict):
        if np.shape(like) != np.shape(state):
            raise ValueError(f"{path or '/'}: shape {np.shape(state)} in the file, "
                             f"{np.shape(like)} expected")
        return state
    if not isinstance(state, dict):
        raise ValueError(f"{path or '/'}: a leaf in the file where a subtree is expected")
    lost = sorted(set(like) - set(state))
    if lost:
        raise ValueError(f"the file lacks keys {lost} at {path or '/'}")
    return {k: _restore(v, state[k], f"{path}/{k}") for k, v in like.items()}


def load_pytree(path: str, like=None):
    """The tree in the msgpack file ``path``; with ``like``, restored by its
    keys (flax's ``from_bytes``: a key ``like`` has and the file lacks is an
    error, one only the file has is left out)."""
    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read())
    return state if like is None else _restore(like, state, "")


def load_metadata(path: str) -> dict:
    meta = path + ".meta.json"
    if not os.path.exists(meta):
        return {}
    with open(meta) as f:
        return json.load(f)


def component_kind(name: str, module: torch.nn.Module) -> str:
    """The rule table of component ``name``: the depth model's by its
    model type, every other component's by name."""
    if name == "depth_model":
        return getattr(module, "model_type", "endodav")
    return COMPONENT_KIND[name]


def component_variables(name: str, module: torch.nn.Module) -> dict:
    """JAX's ``variables[name]`` of ``module``'s current state."""
    return to_jax_params(module.state_dict(), component_kind(name, module))


def load_variables(name: str, module: torch.nn.Module, variables: dict) -> None:
    """JAX's ``variables[name]`` into ``module`` (every parameter and
    buffer; raises on a missing one)."""
    sd = from_jax_params(variables["params"], component_kind(name, module),
                         variables.get("batch_stats"))
    module.load_state_dict(sd, strict=True)


def save_components(folder: str, mods: dict, metadata: dict | None = None) -> None:
    """One ``<name>.msgpack`` a component of ``mods`` ({name: module}), the
    metadata beside the depth model's."""
    os.makedirs(folder, exist_ok=True)
    for name, module in mods.items():
        save_pytree(os.path.join(folder, f"{name}.msgpack"), component_variables(name, module),
                    metadata if name == "depth_model" else None)


def load_components(folder: str, mods: dict, names=None) -> list[str]:
    """Load the components ``names`` (default: all of ``mods``) from
    ``folder``: ``<name>.msgpack``, else a reference ``<name>.pth``.
    Returns the names loaded; a component with neither file keeps its
    weights."""
    loaded = []
    for name in (names or mods):
        module = mods[name]
        native = os.path.join(folder, f"{name}.msgpack")
        reference = os.path.join(folder, f"{name}.pth")
        if os.path.exists(native):
            load_variables(name, module, load_pytree(native, component_variables(name, module)))
        elif os.path.exists(reference):
            report = load_reference_pth(module, reference)
            print(f"[ckpt] loaded {report['loaded']} tensors of {name} from {reference}")
        else:
            continue
        loaded.append(name)
    return loaded
