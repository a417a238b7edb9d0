"""Depth evaluation engine of the port.

Port of `endodav_tpu/eval/engine.py`:
`build_depth_model` (EndoDAV, EndoDAC or AF-SfM from ``--model_type``;
random init from ``--seed``, a ``depth_model.msgpack`` of the JAX
package's layout ahead of reference .pth loads, ``--merge_lora``),
`load_component` (a pose-stack component from ``--load_weights_folder``),
`depth_window_forward` (EndoDAV's whole-model window forward with the
serving defaults of `endodav_tpu/eval/engine.py:248-295`: int8 GEMMs for
the merged vitl graph, dedup at >= 512 patch tokens; a single-frame
model's batch forward) and `evaluate_video_sequences` (window, dedup or
single-frame inference, host or device stitch, alignment, per-frame depth
errors, TAE/TAS), with the same protocol constants: MIN_DEPTH=1e-3,
MAX_DEPTH=150, 95% CI; and the report lines the depth CLIs share,
`print_alignment_summary` and `print_ci_row`.

The kernels' A/B switches are read where JAX reads them (each is an
explicit leg, never a fallback): ``ENDODAV_NO_FLASH`` (`ops/attention.py`),
``ENDODAV_NO_FUSED`` and ``ENDODAV_FUSED_TRAIN`` (`models/motion.py`),
``ENDODAV_NO_WARP_MM`` (`ops/sampling.py`), ``ENDODAV_LOWRES_OUTCONV``
(`models/dpt.py`); `depth_window_forward` prints those that are set.

The JAX engine's ``ENDODAV_SCAN_TRUNK`` and ``ENDODAV_SPLIT_COMPILE`` only
change how XLA compiles the same function; the port runs eagerly and has
neither.  Every LoRA variant serves.  A Dash model serves in the phase
that ``depth_model.msgpack.meta.json`` records (``dash_phase2``, JAX
:110-116), merged in that phase under ``--merge_lora``; from a ``.pth`` it
serves in phase 1, as JAX does.  ``--serve_mesh`` is not ported.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from endodav_tpu_torch.eval import metrics as M
from endodav_tpu_torch.eval.video_inference import (DedupWindowForward, dedup_by_default,
                                                    infer_video_depth,
                                                    infer_video_depth_single_frame)
from endodav_tpu_torch.geometry.transforms import disp_to_depth, transformation_from_parameters
from endodav_tpu_torch.models.afsfm import AFSfMDepth
from endodav_tpu_torch.models.endodac import EndoDAC, endodac_lora_alpha
from endodav_tpu_torch.models.endodav import EndoDAV, endodav_lora_alpha
from endodav_tpu_torch.models.lora import LoRADense, merge_lora_params, set_dash_phase2
from endodav_tpu_torch.utils.checkpoint import load_components, load_metadata
from endodav_tpu_torch.utils.convert import load_reference_pth
from endodav_tpu_torch.utils.precision import set_f32_policy

__all__ = ["SPLITS_DIR", "splits_dir", "resolve_device", "init_random_", "build_depth_model",
           "load_component", "depth_window_forward", "evaluate_video_sequences",
           "sequence_pose_pairs", "evaluate_pose_pairs", "confidence_interval_95", "print_alignment_summary",
           "print_ci_row", "SERVE_SWITCHES", "METRIC_NAMES"]

_DEFAULT_SPLITS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "splits")
# the split files; ENDODAV_TPU_SPLITS_DIR names another directory (JAX :75-78)
SPLITS_DIR = os.environ.get("ENDODAV_TPU_SPLITS_DIR", _DEFAULT_SPLITS)
MIN_DEPTH = 1e-3
MAX_DEPTH = 150.0
# the video evals' metric line: 7 depth errors, then TAE and TAS
METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "tae", "tas")
# the switches `depth_window_forward` reports (JAX :246-251, less the two
# XLA compile strategies, plus the port's opt-in kernel routes)
SERVE_SWITCHES = ("ENDODAV_NO_FLASH", "ENDODAV_NO_FUSED", "ENDODAV_NO_WARP_MM", "ENDODAV_INT8",
                  "ENDODAV_FUSED_RCU", "ENDODAV_FUSED_MLP", "ENDODAV_LOWRES_OUTCONV",
                  "ENDODAV_NO_DEDUP", "ENDODAV_DEDUP")


def splits_dir() -> str:
    """The split directory as the environment names it now (a caller may
    set ``ENDODAV_TPU_SPLITS_DIR`` after this module is imported)."""
    return os.environ.get("ENDODAV_TPU_SPLITS_DIR", _DEFAULT_SPLITS)


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
    modules' proj_out, the ResBottleneck's last norm, Dash's index and
    singular directions), so every path of the serving graph moves the
    output.  ssb's scale vectors stay near 1, as their init of ones.
    """
    ssb = {f"{n}.{leaf}" for n, m in model.named_modules()
           if isinstance(m, LoRADense) and m.variant == "ssb" for leaf in ("lora_A", "lora_B")}
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            noise = torch.randn(p.shape, generator=g)
            if name in ssb:
                value = 1.0 + 0.1 * noise
            elif leaf in ("lora_U", "lora_V"):
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


def _make_model(opt, lora_type: str, temporal_lora: bool):
    residual = [] if opt.disable_residual_block else opt.residual_block_indexes
    if opt.model_type == "endodav":
        return EndoDAV(
            encoder=opt.encoder, r=opt.lora_rank, lora_type=lora_type,
            image_shape=tuple(opt.depth_image_shape), residual_block_indexes=residual,
            include_cls_token=opt.include_cls_token, inv_sigmoid=opt.inv_sigmoid,
            temporal_lora=temporal_lora, conv_head=not opt.disable_conv_head,
            out_sigmoid=opt.out_sigmoid)
    if opt.model_type == "endodac":
        # JAX trainer.build_models: any other encoder serves vits
        return EndoDAC(
            backbone_size={"vits": "vits", "vitb": "vitb"}.get(opt.encoder, "vits"),
            r=opt.lora_rank, lora_type=lora_type, image_shape=tuple(opt.depth_image_shape),
            residual_block_indexes=residual, include_cls_token=opt.include_cls_token,
            pre_norm=opt.pre_norm, inv_sigmoid=opt.inv_sigmoid,
            conv_head=not opt.disable_conv_head)
    if opt.model_type == "afsfm":
        return AFSfMDepth(opt.num_layers, tuple(opt.scales))
    raise ValueError(f"model_type {opt.model_type!r} is not ported")


def _weight_files(opt) -> list[tuple[str, str]]:
    """(submodule, path) of each reference .pth to load (JAX :113-164):
    AF-SfM's two component files, ``encoder.pth`` and ``depth.pth``, from
    ``--load_weights_folder`` (those present); else ``depth_model.pth``
    there, or the pretrained file of ``--pretrained_path``
    (``video_depth_anything_<enc>.pth`` for EndoDAV,
    ``depth_anything_v2_<enc>.pth`` for EndoDAC)."""
    if opt.load_weights_folder:
        folder = os.path.expanduser(opt.load_weights_folder)
        if opt.model_type == "afsfm":
            files = [(sub, os.path.join(folder, f"{sub}.pth")) for sub in ("encoder", "depth")]
            found = [f for f in files if os.path.exists(f[1])]
            if not found:
                raise FileNotFoundError(f"no encoder.pth or depth.pth in {folder}")
            return found
        return [("", os.path.join(folder, "depth_model.pth"))]
    if opt.pretrained_path and opt.model_type != "afsfm":
        name = (f"video_depth_anything_{opt.encoder}.pth" if opt.model_type == "endodav"
                else f"depth_anything_v2_{opt.encoder}.pth")
        return [("", os.path.join(opt.pretrained_path, name))]
    return []


def _native_checkpoint(opt) -> str | None:
    """``depth_model.msgpack`` of ``--load_weights_folder``, if there is one
    (it wins over every .pth, JAX :97-120)."""
    if not opt.load_weights_folder:
        return None
    path = os.path.join(os.path.expanduser(opt.load_weights_folder), "depth_model.msgpack")
    return path if os.path.exists(path) else None


def build_depth_model(opt, device: torch.device | None = None) -> torch.nn.Module:
    """The depth model of ``--model_type`` in eval mode on ``device``:
    seeded random weights, replaced by ``depth_model.msgpack`` of
    ``--load_weights_folder`` (a Dash model switched to the phase its
    metadata records) or else by the reference .pth files that
    `_weight_files` names, LoRA merged on ``--merge_lora`` (with the
    model's own alpha, in the model's Dash phase; galora, whose delta is
    gated by the input, serves unmerged, as JAX :133-137); the f32 policy
    (`set_f32_policy`) set first."""
    device = resolve_device(opt) if device is None else device
    set_f32_policy()
    model = init_random_(_make_model(opt, opt.lora_type, opt.temporal_lora), opt.seed)
    native = _native_checkpoint(opt)
    files = [] if native else _weight_files(opt)
    dash_phase2 = False
    if native:
        load_components(os.path.dirname(native), {"depth_model": model}, ["depth_model"])
        print(f"[eval] loaded {native}")
        if opt.lora_type == "dash":
            dash_phase2 = bool(load_metadata(native).get("dash_phase2", False))
            set_dash_phase2(model, dash_phase2)
            print(f"[eval] dash checkpoint phase: "
                  f"{'2 (post-SVD-boundary)' if dash_phase2 else '1'}")
    for sub, path in files:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no weights at {path}")
        report = load_reference_pth(model.get_submodule(sub), path)
        print(f"[eval] loaded {report['loaded']} tensors from {path} "
              f"({len(report['missing'])} missing, {len(report['unexpected'])} unexpected)")
    if not native and not files:
        print(f"[eval] no weights given; random init from seed {opt.seed}")
    if opt.merge_lora and opt.lora_type == "galora":
        print("[eval] --merge_lora ignored: galora's input-gated delta "
              "cannot be folded into base weights; serving unmerged graph")
    elif opt.merge_lora and opt.lora_type != "none" and opt.model_type != "afsfm":
        r = opt.lora_rank
        alpha = (endodav_lora_alpha if opt.model_type == "endodav"
                 else endodac_lora_alpha)(opt.lora_type, r)
        merged = merge_lora_params(model.state_dict(), opt.lora_type, r, alpha,
                                   dash_phase2=dash_phase2)
        model = _make_model(opt, "none", False)
        model.load_state_dict(merged, strict=True)
        print(f"[eval] merged {opt.lora_type} adapters into base weights (r={r}, alpha={alpha})")
    return model.to(device).eval()


def load_component(opt, name: str, module: torch.nn.Module) -> torch.nn.Module:
    """``module`` loaded from ``<name>.msgpack`` (or a reference
    ``<name>.pth``) of ``--load_weights_folder`` (JAX :176-192); without a
    folder, or with neither file in it, it keeps the weights it has."""
    if not opt.load_weights_folder:
        print(f"[eval] no --load_weights_folder; {name} runs with random init")
        return module
    folder = os.path.expanduser(opt.load_weights_folder)
    if not load_components(folder, {name: module}, [name]):
        print(f"[eval] neither {name}.msgpack nor {name}.pth in {folder}; random init")
    return module


def depth_window_forward(model: torch.nn.Module):
    """EndoDAV: [C, T, h, w, 3] -> [C*T, h', w', 1] sigmoid disparity at
    scale 0, with the serving defaults: int8 GEMMs for the merged vitl graph (unless
    ``ENDODAV_INT8`` is set either way), on a shallow copy of ``model`` so
    that the decision stays with this forward and no env var is written;
    and ``fwd.dedup``, a `DedupWindowForward` where `dedup_by_default`
    picks it (else None).  A model built in bf16 (``EndoDAV(...,
    dtype=torch.bfloat16)`` or ``model.clone(dtype=torch.bfloat16)``, as the
    TPU benchmark builds its headline) serves through both in bf16, int8
    included at vitl.

    A single-frame model (EndoDAC, AF-SfM): [B, h, w, 3] -> [B, h', w', 1],
    with ``fwd.dedup`` None (JAX :395-405).  Prints the model type and the
    A/B switches set (`SERVE_SWITCHES`)."""
    switches = [n for n in SERVE_SWITCHES if os.environ.get(n)]
    model_type = getattr(model, "model_type", "endodav")
    print(f"[serve] forward: model_type={model_type}"
          + (f" env={'+'.join(switches)}" if switches else ""))
    if model_type != "endodav":
        def fwd_single(batch: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return model(batch)[("disp", 0)]

        fwd_single.dedup = None
        fwd_single.model = model
        return fwd_single
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


def print_alignment_summary(depth_align, ratios, align_stats=()):
    """The alignment summary line of the depth eval CLIs (JAX :419-429)."""
    if depth_align == "scale" and len(ratios):
        med = np.median(ratios)
        print(f" Scaling ratios | med: {med:.3f} | std: {np.std(ratios / med):.3f}")
    elif len(align_stats):
        a = np.array(align_stats, dtype=np.float64)
        print(" Aligning shift and scale | t_gt: {:.3f} | s_gt: {:.3f} | "
              "t_pred: {:.3f} | s_pred: {:.3f}".format(*a.mean(axis=0)))


def print_ci_row(*error_arrays):
    """The per-metric 95%-CI ``cls:`` row of the depth eval CLIs over one or
    more [N, K] per-frame error arrays (JAX :432-444)."""
    arrays = [np.asarray(a) for a in error_arrays if len(a)]
    if not arrays:
        print("cls: (no valid frames — every gt mask was empty)")
        return
    cls = [confidence_interval_95(a[:, i]) for a in arrays for i in range(a.shape[1])]
    print("cls: " + " ".join(f"[{lo:.4f}, {hi:.4f}]" for lo, hi in cls))


def evaluate_video_sequences(opt, sequences, forward=None, device=None, max_depth=MAX_DEPTH,
                             with_temporal=True, pred_depths_fn=None,
                             save_folder: str | None = None):
    """Shared video-depth benchmark loop (JAX :488-608); ``opt.model_type``
    picks the window pipeline (endodav) or the single-frame one (endodac,
    afsfm), and ``pred_depths_fn(colors)`` -> disparities replaces both.

    sequences: iterable of dicts with colors/depths[/poses/Ks]/filename (or
    depths + pred_depths in re-eval mode).  ``max_depth`` bounds the
    alignment and the mask; ``with_temporal=False`` drops TAE/TAS.  With
    ``--visualize_depth`` and a ``save_folder``, each sequence writes
    ``<save_folder>/<filename>/vis.mp4`` and ``depth/{i:06d}.npy`` of the
    aligned depths (JAX :553-564).  Returns per-sequence and mean metrics
    and the mean inference time per frame.
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
            if pred_depths_fn is not None:
                disp = pred_depths_fn(data["colors"])
            elif opt.model_type == "endodav":
                disp = infer_video_depth(forward, data["colors"],
                                         image_shape=tuple(opt.depth_image_shape),
                                         chunk_windows=opt.chunk_windows, device=device,
                                         stitch="device" if opt.fast_stitch else "host",
                                         dedup=getattr(forward, "dedup", None))
            else:
                disp = infer_video_depth_single_frame(forward, data["colors"], device=device)
            infer_times.append((time.perf_counter() - t0) / len(data["colors"]) * 1000.0)
            _, pred_depths = disp_to_depth(disp, opt.min_depth, opt.max_depth)

        gt_depths = data["depths"]
        if opt.depth_align == "scale":
            pred_depths, ratio = M.median_scaling(gt_depths, pred_depths, MIN_DEPTH, max_depth)
            if not np.isnan(ratio):
                ratios.append(ratio)
        else:
            pred_depths, *stats = M.align_shift_and_scale(gt_depths, pred_depths, MIN_DEPTH,
                                                          max_depth)
            align_stats.append(stats)

        if opt.visualize_depth and save_folder and "colors" in data:
            seq_dir = os.path.join(save_folder, data.get("filename", f"seq{len(per_sequence)}"))
            depth_dir = os.path.join(seq_dir, "depth")
            os.makedirs(depth_dir, exist_ok=True)
            from endodav_tpu_torch.cli.visualize import save_depth_video

            try:
                save_depth_video(data["colors"], pred_depths, os.path.join(seq_dir, "vis.mp4"))
            except Exception as e:
                print(f"[eval] mp4 export failed ({e}); writing npys only")
            for i in range(pred_depths.shape[0]):
                np.save(os.path.join(depth_dir, f"{i:06d}.npy"), pred_depths[i])

        seq_errors, seq_temp = [], []
        prev = None
        has_pose = with_temporal and "poses" in data
        for idx in range(len(gt_depths)):
            gt = gt_depths[idx]
            pred = pred_depths[idx] * opt.pred_depth_scale_factor
            mask = (gt > MIN_DEPTH) & (gt < max_depth)
            pred = np.clip(pred, MIN_DEPTH, max_depth)
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


def sequence_pose_pairs(data) -> tuple[np.ndarray, np.ndarray]:
    """A sequence's consecutive frame pairs [N-1, H, W, 6] f32 in [0, 1]
    (frame t+1, frame t) and the ground-truth relative poses between them
    [N-1, 4, 4], the inputs of `evaluate_pose_pairs`."""
    colors = data["colors"].astype(np.float32) / 255.0
    poses = data["poses"]
    gt_local = np.stack([(poses[i + 1] @ np.linalg.inv(poses[i])).astype(np.float32)
                         for i in range(len(poses) - 1)])
    return gt_local, np.concatenate([colors[1:], colors[:-1]], axis=-1)


def evaluate_pose_pairs(opt, gt_local_poses, colors_pairs, pose_modules=None, num_tracks=None,
                        device=None):
    """Pairwise pose and intrinsics, then ATE/RE on 5-frame tracks (JAX
    :537-611).

    colors_pairs: [N, H, W, 6] float32 (frame t+1, frame t) pairs, the
    input order of evaluate_pose.py:128-133; ``pose_modules`` the
    (pose encoder, pose decoder, intrinsics head), else built from the
    seed and loaded by `load_component`.  Pairs run 16 at a time (JAX's
    chunk), the last batch ragged.  ``num_tracks`` track windows (default: one a
    pair, the convention of evaluate_depth_video_pose.py:281-288)."""
    device = resolve_device(opt) if device is None else device
    if pose_modules is None:
        from endodav_tpu_torch.models.decoders import IntrinsicsHead, PoseDecoder
        from endodav_tpu_torch.models.resnet import ResNetEncoder, resnet_num_ch_enc
        from endodav_tpu_torch.train.trainer import init_train_

        # the top map's width, which flax takes from feats[-1] (JAX :546-549)
        top = resnet_num_ch_enc(opt.num_layers)[-1]
        mods = init_train_({"pose_encoder": ResNetEncoder(opt.num_layers, num_input_images=2),
                            "pose": PoseDecoder(top, num_frames_to_predict_for=2),
                            "intrinsics_head": IntrinsicsHead(256)}, opt.seed)
        for name, module in mods.items():
            load_component(opt, name, module)
            module.to(device).eval()
        pose_modules = (mods["pose_encoder"], mods["pose"], mods["intrinsics_head"])
    enc, dec, intr = pose_modules
    pred_poses, pred_Ks = [], []
    with torch.inference_mode():
        for c0 in range(0, len(colors_pairs), 16):
            pair = torch.as_tensor(np.asarray(colors_pairs[c0:c0 + 16], np.float32)).to(device)
            axisangle, translation, mid = dec([enc(pair, False)[-1]])
            K = intr(mid, opt.width, opt.height)
            T = transformation_from_parameters(axisangle[:, 0, 0], translation[:, 0, 0])
            pred_poses.append(T.cpu().numpy())
            pred_Ks.append(K[:, :3, :3].cpu().numpy())
    pred_poses, pred_Ks = np.concatenate(pred_poses), np.concatenate(pred_Ks)

    track = 5
    n = min(len(gt_local_poses), len(pred_poses))
    gt_local, pred_local = np.asarray(gt_local_poses)[:n], pred_poses[:n]
    ates, res = [], []
    for i in range(min(n if num_tracks is None else num_tracks, n)):
        local_xyzs = np.array(M.dump_xyz(pred_local[i:i + track - 1]))
        gt_xyzs = np.array(M.dump_xyz(gt_local[i:i + track - 1]))
        local_rs = np.array(M.dump_r(pred_local[i:i + track - 1]))
        gt_rs = np.array(M.dump_r(gt_local[i:i + track - 1]))
        ates.append(M.compute_ate(gt_xyzs, local_xyzs))
        res.append(M.compute_re(local_rs, gt_rs))

    def stat(values, scale):
        return float(values.mean() / scale), float(values.std() / scale)

    return {
        "pred_poses": pred_poses, "pred_intrinsics": pred_Ks,
        "ate_mean": float(np.mean(ates)), "ate_std": float(np.std(ates)),
        "ate_ci": confidence_interval_95(ates),
        "re_mean": float(np.mean(res)), "re_std": float(np.std(res)),
        "intrinsics_stats": {"fx": stat(pred_Ks[:, 0, 0], opt.width),
                             "fy": stat(pred_Ks[:, 1, 1], opt.height),
                             "cx": stat(pred_Ks[:, 0, 2], opt.width),
                             "cy": stat(pred_Ks[:, 1, 2], opt.height)},
    }
