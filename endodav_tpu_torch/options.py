"""Evaluation flags of the port's CLIs.

The video-depth eval subset of `endodav_tpu/options.py`, with the same
names and defaults so shell scripts carry over, plus ``--seed`` for the
random init used when no weights are given.  ``--no_cuda`` selects the
CPU; without it the port runs on CUDA and fails when there is no GPU.
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

        # MODEL
        p.add_argument("--model_type", type=str, choices=["endodav"], default="endodav")
        p.add_argument("--encoder", type=str, choices=["vits", "vitl"], default="vits")
        p.add_argument("--inv_sigmoid", action="store_true")
        p.add_argument("--out_sigmoid", action="store_true")
        p.add_argument("--pretrained_path", type=str, default=None,
                       help="dir holding video_depth_anything_<enc>.pth")
        p.add_argument("--lora_type", type=str, choices=["lora", "dvlora", "none"],
                       default="dvlora")
        p.add_argument("--lora_rank", type=int, default=4)
        p.add_argument("--temporal_lora", action="store_true")
        p.add_argument("--disable_residual_block", action="store_true")
        p.add_argument("--disable_conv_head", action="store_true")
        p.add_argument("--residual_block_indexes", nargs="*", type=int, default=[2, 5, 8, 11])
        p.add_argument("--include_cls_token", type=str2bool, default=True)
        p.add_argument("--min_depth", type=float, default=0.1)
        p.add_argument("--max_depth", type=float, default=150.0)
        p.add_argument("--seed", type=int, default=0,
                       help="seed of the random weights used when no weights are loaded")

        # SYSTEM
        p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
        p.add_argument("--load_weights_folder", type=str, default=None,
                       help="folder holding a reference-convention depth_model.pth")

        # EVALUATION
        p.add_argument("--depth_align", type=str, default="scale_shift",
                       choices=["scale", "scale_shift"])
        p.add_argument("--pred_depth_scale_factor", type=float, default=1)
        p.add_argument("--pred_root", type=str, default=None)
        p.add_argument("--disp2depth", action="store_true")
        p.add_argument("--eval_split", type=str, default="scared_video",
                       choices=["scared_video"])
        p.add_argument("--chunk_windows", type=int, default=2,
                       help="video-depth windows batched per forward pass")
        p.add_argument("--depth_image_shape", nargs=2, type=int, default=[224, 280],
                       help="model-internal (H, W); the 518px config is "
                            "'--depth_image_shape 518 518' with keep-aspect sizing")
        p.add_argument("--merge_lora", action="store_true",
                       help="fold LoRA deltas into the base weights for serving (exact)")

    def parse(self, args=None):
        return self.parser.parse_args(args)
