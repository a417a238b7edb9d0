"""Flags of the port's eval CLIs and trainer.

The flags of `endodav_tpu/options.py`, with the same names, defaults and
choices so shell scripts carry over (``scripts/train_video.sh`` runs both
its commands on the port's CLIs), inert where JAX's are (README "Flags
that are accepted but intentionally inert"), plus ``--seed`` for the
random init used when no weights are given.  ``--mesh_shape data=N``
trains over N ranks and ``--serve_mesh data=N|model=N`` serves over N
(`parallel/`); the CLIs start the ranks themselves, or join ``torchrun``'s.
``--no_cuda`` selects the CPU; without it the port runs on CUDA and fails
when there is no GPU.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["EndoDAVOptions"]


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


class EndoDAVOptions:
    def __init__(self):
        p = argparse.ArgumentParser(description="endodav_tpu_torch options")
        self.parser = p

        p.add_argument("--data_path", type=str, default=os.path.join(os.getcwd(), "endovis_data"))
        p.add_argument("--log_dir", type=str, default=os.path.join(os.path.expanduser("~"), "tmp"),
                       help="the trainer writes <log_dir>/<model_type>/models/")

        # MODEL
        p.add_argument("--model_type", type=str, choices=["endodav", "endodac", "afsfm"],
                       default="endodav")
        p.add_argument("--encoder", type=str, choices=["vits", "vitb", "vitl"], default="vits",
                       help="vitb serves EndoDAC only; EndoDAC takes vitl as vits (as JAX)")
        p.add_argument("--pre_norm", action="store_true",
                       help="EndoDAC: ImageNet-normalize the resized input")
        p.add_argument("--inv_sigmoid", action="store_true")
        p.add_argument("--out_sigmoid", action="store_true")
        p.add_argument("--pretrained_path", type=str, default=None,
                       help="dir holding video_depth_anything_<enc>.pth (endodav) or "
                            "depth_anything_v2_<enc>.pth (endodac)")
        p.add_argument("--lora_type", type=str, choices=["lora", "dvlora", "ssb", "dash", "none"],
                       default="dvlora")
        p.add_argument("--lora_rank", type=int, default=4)
        p.add_argument("--warm_up_step", type=int, default=20000)
        p.add_argument("--tune_depth_interval", type=int, default=-1)
        p.add_argument("--temporal_lora", action="store_true")
        p.add_argument("--tune_temporal_interval", type=int, default=100)
        p.add_argument("--tune_spatial_interval", type=int, default=300)
        p.add_argument("--disable_residual_block", action="store_true")
        p.add_argument("--disable_conv_head", action="store_true")
        p.add_argument("--residual_block_indexes", nargs="*", type=int, default=[2, 5, 8, 11])
        p.add_argument("--include_cls_token", type=str2bool, default=True)
        p.add_argument("--learn_intrinsics", type=str2bool, default=True)
        p.add_argument("--min_depth", type=float, default=0.1)
        p.add_argument("--max_depth", type=float, default=150.0)
        p.add_argument("--seed", type=int, default=0,
                       help="seed of the random weights used when no weights are loaded")

        # TRAINING
        p.add_argument("--num_layers", type=int, default=18, choices=[18, 34, 50, 101, 152])
        p.add_argument("--frame_max_interval", type=int, default=1)
        p.add_argument("--height", type=int, default=256)
        p.add_argument("--width", type=int, default=320)
        p.add_argument("--depth_reproj", type=float, default=0.0)
        p.add_argument("--depth_flow", type=float, default=0.0)
        p.add_argument("--disparity_smoothness", type=float, default=1e-3)
        p.add_argument("--position_smoothness", type=float, default=1e-3)
        p.add_argument("--transform_constraint", type=float, default=0.01)
        p.add_argument("--transform_smoothness", type=float, default=0.01)
        p.add_argument("--scales", nargs="+", type=int, default=[0, 1, 2, 3])
        p.add_argument("--frame_ids", nargs="+", type=int, default=[0, -1, 1])
        p.add_argument("--train_output_conv", action="store_true")
        p.add_argument("--legacy_frozen_groups", nargs="*", type=str, default=[],
                       help="schedule groups whose optimizer gate is forced to 0")
        p.add_argument("--no_ssim", action="store_true")
        p.add_argument("--use_stereo", action="store_true",
                       help="recorded in the checkpoint's metadata, as JAX does")
        p.add_argument("--random_train", action="store_true",
                       help="sample independent frames while the pose side trains "
                            "(--tune_depth_interval alternation)")
        p.add_argument("--host_preprocess", action="store_true",
                       help="build the training pyramid and jitter on the host "
                            "(default: on the card from the scale-0 frames)")
        p.add_argument("--split", type=str, choices=["endovis", "scared_video"],
                       default="scared_video",
                       help="accepted for the shipped scripts' sake; the trainer reads the "
                            "split of --model_type, as JAX's")
        p.add_argument("--model_name", type=str, default="endodav",
                       help="accepted, inert (as JAX's): the log folder is <log_dir>/<model_type>")
        p.add_argument("--dataset", type=str, default="scared_video",
                       choices=["endovis", "scared_video"], help="accepted, inert (as JAX's)")
        p.add_argument("--png", action="store_true", help="accepted, inert (as JAX's)")
        p.add_argument("--weights_init", type=str, default="pretrained",
                       choices=["pretrained", "scratch"], help="accepted, inert (as JAX's)")

        # ABLATION (JAX's flags; the video trainer reads only the last three)
        p.add_argument("--v1_multiscale", action="store_true", help="accepted, inert (as JAX's)")
        p.add_argument("--avg_reprojection", action="store_true",
                       help="accepted, inert (as JAX's)")
        p.add_argument("--disable_automasking", action="store_true",
                       help="accepted, inert (as JAX's)")
        p.add_argument("--predictive_mask", action="store_true",
                       help="build the predictive-mask DepthDecoder, which no loss reads and "
                            "no checkpoint carries (as JAX's)")
        p.add_argument("--pose_model_input", type=str, default="pairs", choices=["pairs", "all"],
                       help="the video trainer runs 'pairs' only; 'all' raises, as JAX's")
        p.add_argument("--pose_model_type", type=str, default="separate_resnet",
                       choices=["posecnn", "separate_resnet", "shared"],
                       help="the video trainer runs 'separate_resnet' only; the others raise, "
                            "as JAX's (PoseCNN is models/decoders.py:PoseCNN)")

        # OPTIMIZATION
        p.add_argument("--batch_size", type=int, default=8)
        p.add_argument("--T", type=int, default=-1)
        p.add_argument("--learning_rate", type=float, default=1e-4)
        p.add_argument("--num_epochs", type=int, default=20)
        p.add_argument("--scheduler_step_size", type=int, default=10)

        # SYSTEM
        p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
        p.add_argument("--use_dp", action="store_true",
                       help="accepted, inert (as JAX's): data parallelism is --mesh_shape")
        p.add_argument("--mesh_shape", type=str, default="",
                       help="device mesh as 'data=N' (default: all local devices on one data "
                            "axis)")
        p.add_argument("--num_workers", type=int, default=4)
        p.add_argument("--compute_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"],
                       help="the trainer's compute dtype (parameters stay f32)")
        p.add_argument("--log_frequency", type=int, default=400)
        p.add_argument("--save_frequency", type=int, default=5,
                       help="accepted for the JAX CLI's sake; every epoch is saved")
        p.add_argument("--load_weights_folder", type=str, default=None,
                       help="a weights_* folder (<component>.msgpack, as the JAX package "
                            "writes), or reference-convention .pth files "
                            "(afsfm: encoder.pth and depth.pth)")
        p.add_argument("--models_to_load", nargs="+", type=str,
                       default=["position_encoder", "position"],
                       help="the components the trainer loads from --load_weights_folder")

        # EVALUATION
        p.add_argument("--depth_align", type=str, default="scale_shift",
                       choices=["scale", "scale_shift"])
        p.add_argument("--pred_depth_scale_factor", type=float, default=1)
        p.add_argument("--pred_root", type=str, default=None)
        p.add_argument("--disp2depth", action="store_true")
        p.add_argument("--eval_split", type=str, default="scared_video",
                       choices=["hamlyn", "c3vd", "endovis", "scared_video", "hamlyn_video"])
        p.add_argument("--eval_stereo", action="store_true", help="accepted, inert (as JAX's)")
        p.add_argument("--eval_eigen_to_benchmark", action="store_true",
                       help="accepted, inert (as JAX's)")
        p.add_argument("--eval_out_dir", type=str, help="accepted, inert (as JAX's)")
        p.add_argument("--no_eval", action="store_true", help="accepted, inert (as JAX's)")
        p.add_argument("--save_recon", action="store_true", help="accepted, inert (as JAX's)")
        p.add_argument("--max_length", type=int, default=None,
                       help="the Hamlyn video eval: the first N frames of each sequence")
        p.add_argument("--disable_median_scaling", action="store_true")
        p.add_argument("--eval_mono", action="store_true",
                       help="accepted for the shipped scripts' sake (monocular is the only mode)")
        p.add_argument("--ext_disp_to_eval", type=str, default=None,
                       help="evaluate_depth: an .npy of already-scaled disparities")
        p.add_argument("--save_pred_disps", action="store_true")
        p.add_argument("--visualize_depth", action="store_true",
                       help="the video evals (evaluate_depth_video, the Hamlyn eval) write "
                            "vis.mp4 and the aligned depth .npy files of each sequence under "
                            "<load_weights_folder>/eval/<eval_split>; the trainer and "
                            "evaluate_depth_video_pose write nothing with it, as JAX's")
        p.add_argument("--post_process", action="store_true",
                       help="evaluate_depth: also run each image flipped, and keep the "
                            "unflipped result (the reference's protocol)")
        p.add_argument("--post_process_blend", action="store_true",
                       help="evaluate_depth: blend the flipped pass in (Monodepth v1)")
        p.add_argument("--chunk_windows", type=int, default=2,
                       help="video-depth windows batched per forward pass")
        p.add_argument("--depth_image_shape", nargs=2, type=int, default=[224, 280],
                       help="model-internal (H, W); the 518px config is "
                            "'--depth_image_shape 518 518' with keep-aspect sizing")
        p.add_argument("--serve_mesh", type=str, default="",
                       help="'data=N': shard video-depth window chunks over N devices "
                            "(throughput); 'model=N': tensor-parallel ViT trunk over N "
                            "devices (per-window latency; needs --merge_lora)")
        p.add_argument("--fast_stitch", action="store_true",
                       help="stitch the windows on the device instead of the host")
        p.add_argument("--merge_lora", action="store_true",
                       help="fold LoRA deltas into the base weights for serving (exact)")

    def parse(self, args=None):
        return self.parser.parse_args(args)
