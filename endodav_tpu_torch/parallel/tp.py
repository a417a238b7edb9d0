"""Tensor parallelism for the ViT trunk: a Megatron split over ranks.

Port of `endodav_tpu/parallel/tp.py`.  Data parallelism (`parallel`'s
``data`` axis) scales throughput; this cuts the latency of one window by
splitting each block's four projections over the ``model`` axis:

  qkv  [3C, C]  -> output rows by head group, after `tp_prepare_params`
                   permutes them so a rank's contiguous rows are its own
                   packed [q|k|v] panel ((3, H, Dh) -> (g, 3, H/g, Dh))
  proj [C, C]   -> input columns (head-group order already); summed
  fc1  [4C, C]  -> output rows
  fc2  [C, 4C]  -> input columns; summed

(PyTorch's ``Linear.weight`` is the transpose of flax's kernel, so JAX's
column split is a row split here and its row split a column split.)  Each
block sums two [B, N, C] partials over the ``model`` group; everything
else (patch embed, norms, LayerScale, ResBottleneck, the DPT head) runs
replicated on every rank.  The proj and fc2 biases are divided by g, so
that the summed bias is exact.  The local model is the same module with
``tp_groups=g`` (`models/vit.py`), and the kernels see ordinary local
tensors: flash attention at H/g heads, the fused MLP at 4C/g hidden units.

Scope, as in JAX: the merged serving graph (``lora_type='none'``).

`TPDedupWindowForward` is the dedup pipeline of the port's current
`DedupWindowForward` contract (``encode``, ``encode_batch_for``,
``head_for``, the prefix/taps rule) over a TP trunk: on a 2-D (data,
model) mesh the encode batch is cut over ``data`` when ``data`` divides
it and gathered back, and the head runs replicated.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.eval.video_inference import DedupWindowForward
from endodav_tpu_torch.parallel import Mesh, all_gather_rows, data_sharding, world_devices

__all__ = ["build_tp_mesh", "tp_prepare_params", "tp_param_specs", "tp_shard", "tp_local_model",
           "tp_window_forward", "TPDedupWindowForward"]

_MERGED_ONLY = ("tensor parallelism expects the merged serving graph (lora_type='none'); "
                "fold adapters with merge_lora_params first")


def build_tp_mesh(n: int, devices=None, data: int = 1) -> Mesh:
    """The 1-D ``model`` mesh, or with ``data`` > 1 the 2-D (data, model)
    grid (rank = data index * n + model index), over the first n*data of
    ``devices`` (default: the world's)."""
    if n < 1:
        raise ValueError(f"tensor-parallel mesh needs 'model=N' with N >= 1, got {n}")
    devs = list(devices if devices is not None else world_devices())
    if n * data > len(devs):
        raise ValueError(f"tensor-parallel mesh wants {n * data} devices, "
                         f"only {len(devs)} visible")
    shape = {"data": data, "model": n} if data > 1 else {"model": n}
    return Mesh(devs[:n * data], shape)


def _role(key: str) -> str | None:
    """'qkv', 'proj', 'fc1' or 'fc2' for a trunk projection's parameter."""
    parts = key.split(".")
    if parts[0] != "pretrained":
        return None
    if "qkv" in parts:
        return "qkv"
    if "proj" in parts and "attn" in parts:
        return "proj"
    for name in ("fc1", "fc2"):
        if name in parts:
            return name
    return None


def tp_prepare_params(state_dict: dict, g: int, num_heads: int) -> dict:
    """The global state dict transformed for a g-way split: the qkv rows
    (weight and bias) permuted (3, H, Dh) -> (g, 3, H/g, Dh), the proj and
    fc2 biases divided by g, every other entry as it is.  A new dict; the
    transformed tensors are new."""
    if num_heads % g:
        raise ValueError(f"num_heads={num_heads} not divisible by tp={g}")
    out = {}
    for key, t in state_dict.items():
        role, leaf = _role(key), key.rsplit(".", 1)[-1]
        if role == "qkv":
            c3 = t.shape[0]
            dh = c3 // 3 // num_heads
            parts = t.reshape(3, g, num_heads // g, dh, *t.shape[1:])
            t = parts.transpose(0, 1).reshape(c3, *t.shape[1:]).contiguous()
        elif role in ("proj", "fc2") and leaf == "bias":
            t = t / g
        out[key] = t
    return out


def tp_param_specs(state_dict: dict) -> dict:
    """The dimension each entry is split along (None: replicated): qkv and
    fc1 weights and biases on their output rows (0), proj and fc2 weights
    on their input columns (1)."""
    specs = {}
    for key in state_dict:
        role, leaf = _role(key), key.rsplit(".", 1)[-1]
        if role in ("qkv", "fc1") and leaf in ("weight", "bias"):
            specs[key] = 0
        elif role in ("proj", "fc2") and leaf == "weight":
            specs[key] = 1
        else:
            specs[key] = None
    return specs


def tp_shard(prepared: dict, g: int, index: int) -> dict:
    """Rank ``index``'s shard of a `tp_prepare_params` state dict."""
    specs = tp_param_specs(prepared)
    out = {}
    for key, t in prepared.items():
        dim = specs[key]
        out[key] = t if dim is None else t.chunk(g, dim=dim)[index].contiguous()
    return out


def tp_local_model(model: torch.nn.Module, g: int) -> torch.nn.Module:
    """The local view of ``model`` (EndoDAV or EndoDAC) for a g-way split:
    the same configuration with ``tp_groups=g`` on ``model``'s device,
    weights not loaded."""
    if getattr(model, "model_type", None) not in ("endodav", "endodac"):
        raise ValueError("tensor parallelism covers the endodav/endodac ViT models, got "
                         f"{type(model).__name__}")
    with torch.device(next(model.parameters()).device):
        return type(model)(**{**model.config, "tp_groups": g, "tp_group": None})


def _load_local(model_local, state_dict: dict, mesh: Mesh, num_heads: int):
    """Load this rank's shard into ``model_local`` on the mesh's device, in
    eval mode, its partial sums bound to the ``model`` group."""
    from endodav_tpu_torch.models.vit import Mlp, SpatialAttention

    if getattr(model_local, "lora_type", "none") != "none":
        raise ValueError(_MERGED_ONLY)
    g = mesh.axis_size("model")
    prepared = tp_prepare_params(state_dict, g, num_heads)
    model_local.load_state_dict(tp_shard(prepared, g, mesh.axis_rank("model")), strict=True)
    group = mesh.group("model")
    for m in model_local.modules():
        if isinstance(m, (Mlp, SpatialAttention)):
            m.tp_group = group
    return model_local.to(mesh.device).eval()


def tp_window_forward(model_local, state_dict: dict, mesh: Mesh, num_heads: int):
    """The TP forward: EndoDAV window chunks [C, T, h, w, 3] -> [C*T, h',
    w', 1], EndoDAC frame batches [B, h, w, 3] -> [B, h', w', 1], the same
    on every rank of the ``model`` group.  ``model_local`` is built with
    ``tp_groups`` = the mesh's ``model`` size (`tp_local_model`) and
    ``lora_type='none'``; ``state_dict`` is the global model's."""
    model = _load_local(model_local, state_dict, mesh, num_heads)

    def fwd(win: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(win)[("disp", 0)]

    fwd.model = model
    fwd.dedup = None
    return fwd


class TPDedupWindowForward(DedupWindowForward):
    """`DedupWindowForward` over a tensor-parallel trunk.

    ``encode`` runs the local trunk (and in prefix mode the head's
    per-frame front half) on the batch, or on this rank's slice of it when
    the mesh's ``data`` axis divides the batch (the streamer's one-frame
    batches run whole on every rank), and gathers the slices back over
    ``data``; ``encode_batch_for``, the prefix/taps rule and ``head_for``
    (the head, replicated) are the single-device pipeline's.  Every rank
    returns the same results."""

    def __init__(self, model_local, state_dict: dict, mesh: Mesh, num_heads: int):
        if getattr(model_local, "lora_type", "none") != "none":
            raise ValueError("TP dedup expects the merged serving graph (lora_type='none'); "
                             "fold adapters with merge_lora_params first")
        self.mesh = mesh
        super().__init__(_load_local(model_local, state_dict, mesh, num_heads))

    def encode(self, batch: torch.Tensor):
        data = self.mesh.axis_size("data")
        if data > 1 and batch.shape[0] % data == 0:
            local = super().encode(batch[data_sharding(batch.shape[0], self.mesh)])
            return tuple(all_gather_rows(r, self.mesh.group("data")) for r in local)
        return super().encode(batch)
