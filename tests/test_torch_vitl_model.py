"""Port parity for vitl at its full widths (trunk 1024 wide with 16 heads,
DPT features 256, out_channels 256/512/1024/1024, temporal blocks at
C=1024 and C=256) against the JAX package on the CPU, int8 off, with the
JAX motion modules on their TPU route (the head-grouped temporal kernel
at C=1024, the ungrouped one at C=256) in interpret mode.

Depth is cut in both packages' config tables: 4 trunk blocks tapped after
every block, in place of 24 tapped at (4, 11, 17, 23), because the full
trunk's init and JAX compile on one CPU core take minutes and over a
gigabyte a copy.  Every block is the same code, so the cut drops repeats,
not paths."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from endodav_tpu_torch.models import endodav as tendodav
from endodav_tpu_torch.models import vit as tvit
from endodav_tpu_torch.utils.convert import endodav_rules, from_jax_params

torch.set_num_threads(1)

DEPTH, TAPS = 4, (0, 1, 2, 3)
CONFIG = dict(encoder="vitl", lora_type="none", residual_block_indexes=())
SHAPE = (28, 42)


def _cut_depth(mp):
    from endodav_tpu.models import endodav as jendodav
    from endodav_tpu.models import vit as jvit

    for table in (jvit.VIT_CONFIGS, tvit.VIT_CONFIGS):
        mp.setitem(table, "vitl", {**table["vitl"], "depth": DEPTH})
    for table in (jendodav.ENDODAV_CONFIGS, tendodav.ENDODAV_CONFIGS):
        mp.setitem(table, "vitl", {**table["vitl"], "intermediate": TAPS})


@pytest.fixture(scope="module")
def vitl_pair():
    """JAX and port vitl EndoDAV (merged, 28x42) with the same random weights."""
    from endodav_tpu.models.endodav import EndoDAV as JEndoDAV

    mp = pytest.MonkeyPatch()
    _cut_depth(mp)
    jm = JEndoDAV(image_shape=SHAPE, **CONFIG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, *SHAPE, 3)))["params"]
    rng = np.random.default_rng(2)
    leaves, tree = jax.tree_util.tree_flatten(params)
    # fan-in scaled, so that the wide layers keep the activations in range
    leaves = [(rng.standard_normal(np.shape(a)) *
               (0.1 if np.ndim(a) < 2 else np.prod(np.shape(a)[:-1]) ** -0.5)).astype(np.float32)
              for a in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    model = tendodav.EndoDAV(image_shape=SHAPE, **CONFIG)
    yield jm, params, model, mp
    mp.undo()


def test_from_jax_params_vitl_writes_every_leaf_once(vitl_pair):
    _, params, model, _ = vitl_pair
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = {tuple(k.key for k in path) for path, _ in flat}
    hits = {}
    for torch_key, flax_key, _ in endodav_rules():
        if flax_key in paths:
            hits[flax_key] = hits.get(flax_key, 0) + 1
    assert set(hits) == paths and set(hits.values()) == {1}
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert len(sd) == len(paths)
    model.load_state_dict(sd, strict=True)  # every port parameter written, none extra


def test_vitl_matches_jax(vitl_pair, monkeypatch):
    """vitl at full widths, T=2: disparity at every scale within 2e-4."""
    from endodav_tpu.models import motion as jmotion

    jm, params, model, _ = vitl_pair
    monkeypatch.delenv("ENDODAV_INT8", raising=False)
    monkeypatch.setattr(jmotion, "_use_fused_block", lambda pos, dim: pos == "ape")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    video = np.random.default_rng(8).uniform(0.05, 0.95, (1, 2, 32, 48, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(video))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(video))
    for s in range(4):
        g, w = got[("disp", s)].numpy(), np.asarray(want[("disp", s)])
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 2e-4, (s, np.abs(g - w).max())


def test_load_reference_pth_vitl_writes_every_leaf_once(vitl_pair, tmp_path):
    """A reference-convention vitl .pth ("module."-prefixed keys) loads with
    every port tensor written once: none missing, none unexpected."""
    from endodav_tpu_torch.eval.engine import init_random_
    from endodav_tpu_torch.utils.convert import load_reference_pth

    src = init_random_(tendodav.EndoDAV(image_shape=SHAPE, **CONFIG), seed=6)
    sd = src.state_dict()
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "depth_model.pth")
    model = tendodav.EndoDAV(image_shape=SHAPE, **CONFIG)
    report = load_reference_pth(model, str(tmp_path / "depth_model.pth"))
    assert report == {"missing": [], "unexpected": [], "loaded": len(sd)}
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
