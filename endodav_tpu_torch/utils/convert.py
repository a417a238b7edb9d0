"""Weight bridge between the JAX package's param trees, reference .pth
files and the port's modules.

The port's parameter names are the reference torch state-dict keys, so a
reference `depth_model.pth` loads with `load_state_dict`.  The rule tables
below are numpy copies of `endodav_tpu/utils/checkpoint.py:build_rules`
for the EndoDAV and EndoDAC (``depth_head.``, with the cls readout
projections) models, the ResNet encoder and the decoders (without the
PoseCNN rows, whose model is not ported), plus the rows of what JAX's
torch loader leaves to flax's init: the BatchNorm of EndoDAC's RCUs
(``use_bn``), and AF-SfM as its two components nested under
``encoder.`` and ``depth.``.  `from_jax_params` runs them backwards,
undoing the `_conv_w`/`_convT_w`/`_lin_w` transposes, and carries flax
``batch_stats`` into the BatchNorm buffers; `to_jax_params` runs them
forwards, from a port state dict to the JAX package's ``variables[name]``
of a component (what `utils/checkpoint.py` writes as msgpack).
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["endodav_rules", "endodac_rules", "afsfm_rules", "resnet_encoder_rules",
           "decoder_rules", "component_rules",
           "COMPONENT_KIND", "from_jax_params", "to_jax_params", "jax_paths", "load_reference_pth",
           "SKIP_PATTERNS"]

# reference keys with no counterpart in the port (checkpoint.py:_SKIP_PATTERNS)
SKIP_PATTERNS = (
    r"\.num_batches_tracked$",
    r"pos_encoder\.pe$",
    r"^height$", r"^width$", r"^use_stereo$",
    r"refinenet4\.resConfUnit1\.",  # the pyramid top never gets a skip input
    r"\.lora_change_",
    r"\.ranknum$",
)

# flax layout -> torch layout
_CONV = "conv"    # flax (kh, kw, I, O) -> torch (O, I, kh, kw)
_CONVT = "convT"  # flax (kh, kw, O, I) -> torch ConvTranspose (I, O, kh, kw)
_LIN = "lin"      # flax (I, O) -> torch (O, I)
_FORWARD = {
    None: lambda v: v,
    _CONV: lambda v: np.transpose(v, (2, 3, 1, 0)),
    _CONVT: lambda v: np.transpose(v, (2, 3, 1, 0)),
    _LIN: lambda v: np.transpose(v, (1, 0)),
}
_INVERSE = {
    None: lambda v: v,
    _CONV: lambda v: np.transpose(v, (3, 2, 0, 1)),
    _CONVT: lambda v: np.transpose(v, (3, 2, 0, 1)),
    _LIN: lambda v: np.transpose(v, (1, 0)),
}


def _vit_block_rules(pt, pf):
    return [
        (pt + "norm1.weight", pf + ("norm1", "scale"), None),
        (pt + "norm1.bias", pf + ("norm1", "bias"), None),
        (pt + "attn.qkv.weight", pf + ("attn", "qkv", "kernel"), _LIN),
        (pt + "attn.qkv.bias", pf + ("attn", "qkv", "bias"), None),
        (pt + "attn.proj.weight", pf + ("attn", "proj", "kernel"), _LIN),
        (pt + "attn.proj.bias", pf + ("attn", "proj", "bias"), None),
        (pt + "ls1.gamma", pf + ("ls1", "gamma"), None),
        (pt + "ls2.gamma", pf + ("ls2", "gamma"), None),
        (pt + "norm2.weight", pf + ("norm2", "scale"), None),
        (pt + "norm2.bias", pf + ("norm2", "bias"), None),
    ]


def _lora_dense_rules(pt, pf):
    rules = [(pt + "weight", pf + ("kernel",), _LIN), (pt + "bias", pf + ("bias",), None)]
    # every variant's adapter leaves keep their layout (JAX checkpoint.py:161,
    # and flora's lora_E)
    for nm in ("lora_A", "lora_B", "lora_U", "lora_V", "lora_E", "lora_index", "weight_u_top",
               "weight_vt_top"):
        rules.append((pt + nm, pf + (nm,), None))
    return rules


def _res_bottleneck_rules(pt, pf):
    rules = []
    for i in (1, 2, 3):
        rules.append((pt + f"conv{i}.weight", pf + (f"conv{i}", "kernel"), _CONV))
        rules.append((pt + f"norm{i}.weight", pf + (f"norm{i}", "weight"), None))
        rules.append((pt + f"norm{i}.bias", pf + (f"norm{i}", "bias"), None))
    return rules


def _motion_module_rules(pt, pf):
    tt = pt + "temporal_transformer."
    rules = [
        (tt + "norm.weight", pf + ("norm", "scale"), None),
        (tt + "norm.bias", pf + ("norm", "bias"), None),
        (tt + "proj_in.weight", pf + ("proj_in", "kernel"), _LIN),
        (tt + "proj_in.bias", pf + ("proj_in", "bias"), None),
        (tt + "proj_out.weight", pf + ("proj_out", "kernel"), _LIN),
        (tt + "proj_out.bias", pf + ("proj_out", "bias"), None),
    ]
    for d in range(4):
        bt, bf = tt + f"transformer_blocks.{d}.", pf + (f"transformer_blocks_{d}",)
        for i in range(4):
            at, af = bt + f"attention_blocks.{i}.", bf + (f"attn_{i}",)
            for nm in ("to_q", "to_k", "to_v"):
                rules.append((at + f"{nm}.weight", af + (nm, "kernel"), _LIN))
            rules.append((at + "to_out.0.weight", af + ("to_out", "kernel"), _LIN))
            rules.append((at + "to_out.0.bias", af + ("to_out", "bias"), None))
            rules.append((bt + f"norms.{i}.weight", bf + (f"norm_{i}", "scale"), None))
            rules.append((bt + f"norms.{i}.bias", bf + (f"norm_{i}", "bias"), None))
        rules.append((bt + "ff.net.0.proj.weight", bf + ("ff", "proj_in", "kernel"), _LIN))
        rules.append((bt + "ff.net.0.proj.bias", bf + ("ff", "proj_in", "bias"), None))
        rules.extend(_lora_dense_rules(bt + "ff.net.2.", bf + ("ff", "proj_out")))
        rules.append((bt + "ff_norm.weight", bf + ("ff_norm", "scale"), None))
        rules.append((bt + "ff_norm.bias", bf + ("ff_norm", "bias"), None))
    return rules


def _bn_rules(pt, pf):
    """A BatchNorm's parameters, and its statistics in the flax collection
    named first in the path ("batch_stats")."""
    return [(pt + "weight", pf + ("scale",), None), (pt + "bias", pf + ("bias",), None),
            (pt + "running_mean", ("batch_stats",) + pf + ("mean",), None),
            (pt + "running_var", ("batch_stats",) + pf + ("var",), None)]


def _dpt_rules(pt, pf):
    rules = []
    for i in range(4):
        rules.append((pt + f"projects.{i}.weight", pf + (f"projects_{i}", "kernel"), _CONV))
        rules.append((pt + f"projects.{i}.bias", pf + (f"projects_{i}", "bias"), None))
        rules.append((pt + f"readout_projects.{i}.0.weight",
                      pf + (f"readout_projects_{i}", "kernel"), _LIN))
        rules.append((pt + f"readout_projects.{i}.0.bias",
                      pf + (f"readout_projects_{i}", "bias"), None))
    for i, kind in (("0", _CONVT), ("1", _CONVT), ("3", _CONV)):
        rules.append((pt + f"resize_layers.{i}.weight", pf + (f"resize_layers_{i}", "kernel"), kind))
        rules.append((pt + f"resize_layers.{i}.bias", pf + (f"resize_layers_{i}", "bias"), None))
    for i in (1, 2, 3, 4):
        rules.append((pt + f"scratch.layer{i}_rn.weight", pf + (f"layer{i}_rn", "kernel"), _CONV))
        rf, rt = pf + (f"refinenet{i}",), pt + f"scratch.refinenet{i}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                rules.append((rt + f"{unit}.{c}.weight", rf + (unit, c, "kernel"), _CONV))
                rules.append((rt + f"{unit}.{c}.bias", rf + (unit, c, "bias"), None))
            for bn in ("bn1", "bn2"):
                rules += _bn_rules(rt + f"{unit}.{bn}.", rf + (unit, bn))
        rules.append((rt + "out_conv.weight", rf + ("out_conv", "kernel"), _CONV))
        rules.append((rt + "out_conv.bias", rf + ("out_conv", "bias"), None))
    for i in (1, 2, 3, 4):
        ht, hf = pt + f"conv_depth_{i}.head.", pf + (f"conv_depth_{i}",)
        for ti, fn in ((0, "conv0"), (2, "conv2"), (4, "conv4")):
            rules.append((ht + f"{ti}.weight", hf + (fn, "kernel"), _CONV))
            rules.append((ht + f"{ti}.bias", hf + (fn, "bias"), None))
    ot, of = pt + "scratch.", pf + ("scratch_output",)
    for tn, fn in (("output_conv1", "output_conv1"), ("output_conv2.0", "output_conv2_0"),
                   ("output_conv2.2", "output_conv2_2")):
        rules.append((ot + f"{tn}.weight", of + (fn, "kernel"), _CONV))
        rules.append((ot + f"{tn}.bias", of + (fn, "bias"), None))
    for m in range(4):
        rules.extend(_motion_module_rules(pt + f"motion_modules.{m}.", pf + (f"motion_modules_{m}",)))
    return rules


def _vit_rules(pt, pf, depth=40):
    rules = [
        (pt + "cls_token", pf + ("cls_token",), None),
        (pt + "pos_embed", pf + ("pos_embed",), None),
        (pt + "mask_token", pf + ("mask_token",), None),
        (pt + "patch_embed.proj.weight", pf + ("patch_embed", "kernel"), _CONV),
        (pt + "patch_embed.proj.bias", pf + ("patch_embed", "bias"), None),
        (pt + "norm.weight", pf + ("norm", "scale"), None),
        (pt + "norm.bias", pf + ("norm", "bias"), None),
    ]
    for i in range(depth):
        bt, bf = pt + f"blocks.{i}.", pf + (f"blocks_{i}",)
        rules.extend(_vit_block_rules(bt, bf))
        rules.extend(_lora_dense_rules(bt + "mlp.fc1.", bf + ("mlp", "fc1")))
        rules.extend(_lora_dense_rules(bt + "mlp.fc2.", bf + ("mlp", "fc2")))
        for nm in ("w12", "w3"):  # the SwiGLU FFN (ffn_layer="swiglu")
            rules.append((bt + f"mlp.{nm}.weight", bf + ("mlp", nm, "kernel"), _LIN))
            rules.append((bt + f"mlp.{nm}.bias", bf + ("mlp", nm, "bias"), None))
        rules.extend(_res_bottleneck_rules(bt + "residual_.", bf + ("residual_",)))
    return rules


def endodav_rules():
    """(torch_key, flax_path, layout) for every EndoDAV parameter."""
    return _vit_rules("pretrained.", ("pretrained",)) + _dpt_rules("head.", ("head",))


def endodac_rules():
    """(torch_key, flax_path, layout) for every EndoDAC parameter and RCU
    BatchNorm statistic."""
    return _vit_rules("pretrained.", ("pretrained",)) + _dpt_rules("depth_head.", ("depth_head",))


def _nest(rules, pt, pf):
    """``rules`` of a component placed at torch prefix ``pt`` and flax
    subtree ``pf`` (after the collection, where the path names one)."""
    out = []
    for tk, fk, layout in rules:
        col = fk[:1] if fk[0] == "batch_stats" else ()
        out.append((pt + tk, col + pf + fk[len(col):], layout))
    return out


def afsfm_rules():
    """(torch_key, flax_path, layout) for `AFSfMDepth`: the ResNet encoder
    under ``encoder.`` and the depth decoder under ``depth.``."""
    return (_nest(resnet_encoder_rules(), "encoder.", ("encoder",))
            + _nest(decoder_rules(), "depth.", ("depth",)))


def resnet_encoder_rules():
    """(torch_key, flax_path, layout) for a ResNetEncoder; BatchNorm
    statistics carry their flax collection as the path's first element
    ("batch_stats"), parameters carry none."""
    rules = [("encoder.conv1.weight", ("conv1", "kernel"), _CONV)]
    bn = _bn_rules
    rules += bn("encoder.bn1.", ("bn1",))
    for stage in range(1, 5):
        for b in range(40):
            bt, bf = f"encoder.layer{stage}.{b}.", (f"layer{stage}_{b}",)
            for i in (1, 2, 3):
                rules.append((bt + f"conv{i}.weight", bf + (f"conv{i}", "kernel"), _CONV))
                rules += bn(bt + f"bn{i}.", bf + (f"bn{i}",))
            rules.append((bt + "downsample.0.weight", bf + ("downsample_conv", "kernel"), _CONV))
            rules += bn(bt + "downsample.1.", bf + ("downsample_bn",))
    return rules


def decoder_rules():
    """(torch_key, flax_path, layout) for the pose, intrinsics, position,
    transform and depth decoders and PoseCNN."""
    rules = []
    for i in range(7):
        rules.append((f"net.{i}.weight", (f"convs_{i}", "kernel"), _CONV))
        rules.append((f"net.{i}.bias", (f"convs_{i}", "bias"), None))
    rules.append(("pose_conv.weight", ("pose_conv", "kernel"), _CONV))
    rules.append(("pose_conv.bias", ("pose_conv", "bias"), None))
    for n in ("squeeze", "pose_0", "pose_1", "pose_2"):
        rules.append((f"convs.{n}.weight", (n, "kernel"), _CONV))
        rules.append((f"convs.{n}.bias", (n, "bias"), None))
    rules.append(("focal_length_conv.weight", ("focal_length_conv", "kernel"), _CONV))
    rules.append(("offsets_conv.weight", ("offsets_conv", "kernel"), _CONV))
    for i in range(5):
        for j in range(2):
            rt, rf = f"convs.upconv_{i}_{j}.conv.conv.", ("unet", f"upconv_{i}_{j}", "conv")
            rules.append((rt + "weight", rf + ("kernel",), _CONV))
            rules.append((rt + "bias", rf + ("bias",), None))
    for s in range(4):
        rules.append((f"convs.position_conv_{s}.weight", (f"position_conv_{s}", "kernel"), _CONV))
        rules.append((f"convs.position_conv_{s}.bias", (f"position_conv_{s}", "bias"), None))
        rules.append((f"convs.transform_conv_{s}.conv.weight",
                      (f"transform_conv_{s}", "conv", "kernel"), _CONV))
        rules.append((f"convs.transform_conv_{s}.conv.bias",
                      (f"transform_conv_{s}", "conv", "bias"), None))
        rules.append((f"convs.dispconv_{s}.conv.weight", (f"dispconv_{s}", "conv", "kernel"),
                      _CONV))
        rules.append((f"convs.dispconv_{s}.conv.bias", (f"dispconv_{s}", "conv", "bias"), None))
    return rules


# rule table of each trainer component
COMPONENT_KIND = {
    "depth_model": "endodav",
    "position_encoder": "resnet_encoder", "transform_encoder": "resnet_encoder",
    "pose_encoder": "resnet_encoder",
    "position": "decoder", "transform": "decoder", "pose": "decoder",
    "intrinsics_head": "decoder",
}


def component_rules(kind: str):
    return {"endodav": endodav_rules, "endodac": endodac_rules, "afsfm": afsfm_rules,
            "resnet_encoder": resnet_encoder_rules, "decoder": decoder_rules}[kind]()


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def from_jax_params(params: dict, kind: str = "endodav",
                    batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """flax params (nested dict of arrays, ``variables["params"]``) and,
    for a model with BatchNorm (a ResNet encoder, AF-SfM, an EndoDAC with
    ``use_bn``), its ``batch_stats`` -> the port's state dict of a
    component of ``kind`` ("endodav", "endodac", "afsfm",
    "resnet_encoder" or "decoder").  Raises if a leaf has no rule."""
    flat = {k: np.asarray(v, dtype=np.float32) for k, v in _flatten(params).items()}
    if batch_stats is not None:
        flat.update({("batch_stats",) + k: np.asarray(v, dtype=np.float32)
                     for k, v in _flatten(batch_stats).items()})
    sd, used = {}, set()
    for torch_key, flax_key, layout in component_rules(kind):
        if flax_key in flat:
            sd[torch_key] = torch.from_numpy(np.array(_INVERSE[layout](flat[flax_key]), order="C"))
            used.add(flax_key)
    missing = sorted("/".join(k) for k in flat if k not in used)
    if missing:
        raise ValueError(f"no conversion rule for {len(missing)} JAX leaves: {missing[:8]}")
    return sd


def jax_paths(kind: str) -> dict:
    """{port key: (torch layout, path in JAX's variables)} of a component of
    ``kind``; the path starts with its collection, "params" or
    "batch_stats"."""
    return {tk: (layout, fk if fk[0] == "batch_stats" else ("params",) + fk)
            for tk, fk, layout in component_rules(kind)}


def to_jax_params(state_dict: dict, kind: str = "endodav") -> dict:
    """The port's state dict of a component of ``kind`` (or any subset of
    it, such as Adam's moments of its parameters) -> JAX's variables of
    that component: ``{"params": ...}``, with ``"batch_stats"`` beside it
    where the state dict holds BatchNorm statistics; kernels in flax's
    layout, float32 numpy leaves.  Raises if a key has no rule."""
    paths = jax_paths(kind)
    missing = sorted(k for k in state_dict if k not in paths)
    if missing:
        raise ValueError(f"no conversion rule for {len(missing)} port keys: {missing[:8]}")
    out: dict = {}
    for key, value in state_dict.items():
        layout, path = paths[key]
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        arr = value.detach().cpu().float().numpy() if torch.is_tensor(value) else value
        node[path[-1]] = np.ascontiguousarray(_FORWARD[layout](np.asarray(arr, np.float32)))
    return out


def load_reference_pth(model: torch.nn.Module, path: str) -> dict:
    """Load a reference-convention .pth into ``model``; returns the report
    of keys the model expected but the file lacked, and the reverse."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()
          if hasattr(v, "shape")}
    sd = {k: v for k, v in sd.items() if not any(re.search(p, k) for p in SKIP_PATTERNS)}
    result = model.load_state_dict(sd, strict=False)
    return {"missing": list(result.missing_keys), "unexpected": list(result.unexpected_keys),
            "loaded": len(sd) - len(result.unexpected_keys)}
