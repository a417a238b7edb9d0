"""Video-depth evaluation engine of the port.

Port of the EndoDAV serving part of `endodav_tpu/eval/engine.py`:
`build_depth_model` (random init from ``--seed``, reference .pth load,
``--merge_lora``), `depth_window_forward` (the whole-model window
forward with the serving defaults of `endodav_tpu/eval/engine.py:248-295`:
int8 GEMMs for the merged vitl graph, dedup at >= 512 patch tokens) and
`evaluate_video_sequences` (window or dedup inference, host or device
stitch, alignment, per-frame depth errors, TAE/TAS), with the same
protocol constants: MIN_DEPTH=1e-3, MAX_DEPTH=150, 95% CI.

The JAX engine's ``ENDODAV_SCAN_TRUNK`` and ``ENDODAV_SPLIT_COMPILE`` only
change how XLA compiles the same function; the port runs eagerly and has
neither.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from endodav_tpu_torch.eval import metrics as M
from endodav_tpu_torch.eval.video_inference import (DedupWindowForward, dedup_by_default,
                                                    infer_video_depth)
from endodav_tpu_torch.geometry.transforms import disp_to_depth
from endodav_tpu_torch.models.endodav import EndoDAV, endodav_lora_alpha
from endodav_tpu_torch.models.lora import merge_lora_params
from endodav_tpu_torch.utils.convert import load_reference_pth
from endodav_tpu_torch.utils.precision import set_f32_policy

__all__ = ["SPLITS_DIR", "resolve_device", "init_random_", "build_depth_model",
           "depth_window_forward", "evaluate_video_sequences", "confidence_interval_95"]

SPLITS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "splits")
MIN_DEPTH = 1e-3
MAX_DEPTH = 150.0


def resolve_device(opt) -> torch.device:
    """CUDA unless ``--no_cuda``; finding no GPU is an error, never a CPU run."""
    if getattr(opt, "no_cuda", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --no_cuda to run on the CPU")
    return torch.device("cuda")


def init_random_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter with seeded random values of a sensible scale.

    Unlike a training init, no layer starts at zero (LoRA B, the motion
    modules' proj_out, the ResBottleneck's last norm), so every path of
    the serving graph moves the output.
    """
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            noise = torch.randn(p.shape, generator=g)
            if leaf in ("lora_U", "lora_V"):
                value = torch.rand(p.shape, generator=g) * 2 - 1
            elif leaf == "gamma":  # LayerScale
                value = 0.1 + 0.02 * noise
            elif leaf in ("cls_token", "pos_embed", "mask_token"):
                value = 0.02 * noise
            elif p.ndim == 1 and leaf == "weight":  # norms
                value = 1.0 + 0.1 * noise
            elif p.ndim == 1:  # biases
                value = 0.02 * noise
            else:  # matrices and conv kernels: fan-in scaled
                value = noise * p[0].numel() ** -0.5
            p.copy_(value)
    return model


def _make_model(opt, lora_type: str, temporal_lora: bool) -> EndoDAV:
    if opt.model_type != "endodav":
        raise ValueError(f"model_type {opt.model_type!r} is not ported; only endodav serves")
    return EndoDAV(
        encoder=opt.encoder, r=opt.lora_rank, lora_type=lora_type,
        image_shape=tuple(opt.depth_image_shape),
        residual_block_indexes=[] if opt.disable_residual_block else opt.residual_block_indexes,
        include_cls_token=opt.include_cls_token, inv_sigmoid=opt.inv_sigmoid,
        temporal_lora=temporal_lora, conv_head=not opt.disable_conv_head,
        out_sigmoid=opt.out_sigmoid)


def build_depth_model(opt, device: torch.device | None = None) -> EndoDAV:
    """The EndoDAV model in eval mode on ``device``: seeded random weights,
    replaced by a reference .pth when one is found, LoRA merged on
    ``--merge_lora``; the f32 policy (`set_f32_policy`) set first."""
    device = resolve_device(opt) if device is None else device
    set_f32_policy()
    model = init_random_(_make_model(opt, opt.lora_type, opt.temporal_lora), opt.seed)
    path = None
    if opt.load_weights_folder:
        path = os.path.join(os.path.expanduser(opt.load_weights_folder), "depth_model.pth")
    elif opt.pretrained_path:
        path = os.path.join(opt.pretrained_path, f"video_depth_anything_{opt.encoder}.pth")
    if path is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no weights at {path}")
        report = load_reference_pth(model, path)
        print(f"[eval] loaded {report['loaded']} tensors from {path} "
              f"({len(report['missing'])} missing, {len(report['unexpected'])} unexpected)")
    else:
        print(f"[eval] no weights given; random init from seed {opt.seed}")
    if opt.merge_lora and opt.lora_type != "none":
        r = opt.lora_rank
        alpha = endodav_lora_alpha(opt.lora_type, r)
        merged = merge_lora_params(model.state_dict(), opt.lora_type, r, alpha)
        model = _make_model(opt, "none", False)
        model.load_state_dict(merged, strict=True)
        print(f"[eval] merged {opt.lora_type} adapters into base weights (r={r}, alpha={alpha})")
    return model.to(device).eval()


def depth_window_forward(model: EndoDAV):
    """[C, T, h, w, 3] -> [C*T, h', w', 1] sigmoid disparity at scale 0, with
    the serving defaults: int8 GEMMs for the merged vitl graph (unless
    ``ENDODAV_INT8`` is set either way), on a shallow copy of ``model`` so
    that the decision stays with this forward and no env var is written;
    and ``fwd.dedup``, a `DedupWindowForward` where `dedup_by_default`
    picks it (else None).  A model built in bf16 (``EndoDAV(...,
    dtype=torch.bfloat16)`` or ``model.clone(dtype=torch.bfloat16)``, as the
    TPU benchmark builds its headline) serves through both in bf16, int8
    included at vitl."""
    if model.encoder == "vitl" and model.lora_type == "none" and "ENDODAV_INT8" not in os.environ:
        model = copy.copy(model)
        model.int8_serving = True
        print("[serve] vitl int8 serving GEMMs: on (auto; ENDODAV_INT8=0 opts out)")

    def fwd(win: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(win)[("disp", 0)]

    fwd.dedup = DedupWindowForward(model) if dedup_by_default(model.image_shape) else None
    fwd.model = model
    return fwd


def confidence_interval_95(values):
    import scipy.stats as st

    values = np.asarray(values)
    if len(values) < 2:
        return np.array([np.nan, np.nan])
    return np.array(st.t.interval(0.95, df=len(values) - 1, loc=np.mean(values),
                                  scale=st.sem(values)))


def evaluate_video_sequences(opt, sequences, forward=None, device=None):
    """Shared video-depth benchmark loop.

    sequences: iterable of dicts with colors/depths/poses/Ks/filename (or
    depths + pred_depths in re-eval mode).  Returns per-sequence and mean
    metrics and the mean inference time per frame.
    """
    device = resolve_device(opt) if device is None else device
    errors, errors_temp, ratios, align_stats, per_sequence, infer_times = [], [], [], [], [], []
    for data in sequences:
        if "pred_depths" in data:
            pred_depths = data["pred_depths"].astype(np.float64)
            if opt.disp2depth:
                _, pred_depths = disp_to_depth(pred_depths, opt.min_depth, opt.max_depth)
        else:
            t0 = time.perf_counter()
            disp = infer_video_depth(forward, data["colors"],
                                     image_shape=tuple(opt.depth_image_shape),
                                     chunk_windows=opt.chunk_windows, device=device,
                                     stitch="device" if opt.fast_stitch else "host",
                                     dedup=getattr(forward, "dedup", None))
            infer_times.append((time.perf_counter() - t0) / len(data["colors"]) * 1000.0)
            _, pred_depths = disp_to_depth(disp, opt.min_depth, opt.max_depth)

        gt_depths = data["depths"]
        if opt.depth_align == "scale":
            pred_depths, ratio = M.median_scaling(gt_depths, pred_depths, MIN_DEPTH, MAX_DEPTH)
            if not np.isnan(ratio):
                ratios.append(ratio)
        else:
            pred_depths, *stats = M.align_shift_and_scale(gt_depths, pred_depths, MIN_DEPTH,
                                                          MAX_DEPTH)
            align_stats.append(stats)

        seq_errors, seq_temp = [], []
        prev = None
        has_pose = "poses" in data
        for idx in range(len(gt_depths)):
            gt = gt_depths[idx]
            pred = pred_depths[idx] * opt.pred_depth_scale_factor
            mask = (gt > MIN_DEPTH) & (gt < MAX_DEPTH)
            pred = np.clip(pred, MIN_DEPTH, MAX_DEPTH)
            e = M.compute_errors(gt, pred, mask)
            if not np.isnan(e).all():
                seq_errors.append(e)
            if has_pose:
                i2l = np.linalg.inv(data["Ks"][idx] @ data["poses"][idx])
                if prev is not None:
                    seq_temp.append([M.tae(prev[0], prev[1], prev[2], pred, mask, i2l) * 100.0,
                                     M.tas(prev[0], prev[1], prev[2], pred, mask, i2l)])
                prev = (pred, mask, i2l)
        errors.extend(seq_errors)
        errors_temp.extend(seq_temp)
        per_sequence.append({
            "filename": data.get("filename", ""),
            "errors": np.array(seq_errors).mean(0).tolist() if seq_errors else None,
            "temporal": np.array(seq_temp).mean(0).tolist() if seq_temp else None,
        })

    return {
        "mean_errors": np.array(errors).mean(0) if errors else np.full(7, np.nan),
        "all_errors": np.array(errors),
        "ci": confidence_interval_95([e[0] for e in errors]),
        "mean_temporal": np.array(errors_temp).mean(0) if errors_temp else None,
        "all_temporal": np.array(errors_temp),
        "per_sequence": per_sequence,
        "mean_infer_ms": float(np.mean(infer_times)) if infer_times else None,
        "ratios": ratios,
        "align_stats": align_stats,
    }
