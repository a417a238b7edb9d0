"""Single-image or folder depth demo, served by the port.

Run as ``python -m endodav_tpu_torch.cli.test_simple --image_path <file or
folder> [--model_type endodac|endodav|afsfm] [--no_cuda]``.  Port of
`endodav_tpu/cli/test_simple.py`: for each image, `predict_disparity`
gives the model's disparity at the source size on the model's device,
and `save_disparity` writes ``<name>_disp.npy`` and a magma-coloured
``<name>_disp.jpeg`` on the host (matplotlib is imported there only).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from endodav_tpu_torch.data.readers import read_image
from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.ops.resize import resize2d
from endodav_tpu_torch.options import str2bool


def parse_args(args=None):
    p = argparse.ArgumentParser(description="simple depth prediction")
    p.add_argument("--image_path", type=str, required=True, help="image file or folder")
    p.add_argument("--load_weights_folder", type=str, default=None)
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--model_type", type=str, default="endodac",
                   choices=["endodav", "endodac", "afsfm"])
    p.add_argument("--encoder", type=str, default="vits", choices=["vits", "vitb", "vitl"])
    p.add_argument("--lora_type", type=str, default="lora", choices=["lora", "dvlora", "none"])
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--residual_block_indexes", nargs="*", type=int, default=[2, 5, 8, 11])
    p.add_argument("--include_cls_token", type=str2bool, default=True)
    p.add_argument("--disable_residual_block", action="store_true")
    p.add_argument("--disable_conv_head", action="store_true")
    p.add_argument("--pre_norm", action="store_true")
    p.add_argument("--inv_sigmoid", action="store_true")
    p.add_argument("--out_sigmoid", action="store_true")
    p.add_argument("--temporal_lora", action="store_true")
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=150.0)
    p.add_argument("--num_layers", type=int, default=18, choices=[18, 34, 50, 101, 152])
    p.add_argument("--scales", nargs="+", type=int, default=[0, 1, 2, 3])
    p.add_argument("--depth_image_shape", nargs=2, type=int, default=[224, 280])
    p.add_argument("--ext", type=str, default="png")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--merge_lora", action="store_true",
                   help="fold LoRA deltas into base weights for serving (exact)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when no weights are loaded")
    p.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    return p.parse_args(args)


def predict_disparity(model: torch.nn.Module, image: np.ndarray) -> torch.Tensor:
    """The disparity [H, W] of one uint8 image [H, W, 3] at its own size, on
    the model's device: the model's ("disp", 0) (EndoDAV takes the image as
    a one-frame video) upsampled bilinearly with align_corners=True."""
    device = next(model.parameters()).device
    h, w = image.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).float()[None] / 255.0
    if model.model_type == "endodav":
        x = x[:, None]
    with torch.inference_mode():
        disp = model(x)[("disp", 0)].float()
        return resize2d(disp, (h, w), "bilinear", align_corners=True)[0, ..., 0]


def save_disparity(disp: np.ndarray, out_dir: str, name: str) -> None:
    """``<name>_disp.npy`` and the magma jpeg (colours clipped at the 95th
    percentile)."""
    import matplotlib
    from PIL import Image

    np.save(os.path.join(out_dir, f"{name}_disp.npy"), disp)
    vmax = np.percentile(disp, 95)
    normed = np.clip(disp / max(vmax, 1e-9), 0, 1)
    colored = (matplotlib.colormaps["magma"](normed)[..., :3] * 255).astype(np.uint8)
    Image.fromarray(colored).save(os.path.join(out_dir, f"{name}_disp.jpeg"))
    print(f"saved {name}_disp.npy / .jpeg")


def test_simple(opt):
    model = engine.build_depth_model(opt)
    if os.path.isfile(opt.image_path):
        paths = [opt.image_path]
        out_dir = opt.output_dir or os.path.dirname(opt.image_path)
    else:
        paths = sorted(glob.glob(os.path.join(opt.image_path, f"*.{opt.ext}")))
        out_dir = opt.output_dir or opt.image_path
    os.makedirs(out_dir, exist_ok=True)
    for path in paths:
        disp = predict_disparity(model, read_image(path)).cpu().numpy()
        save_disparity(disp, out_dir, os.path.splitext(os.path.basename(path))[0])


def main():
    test_simple(parse_args())


if __name__ == "__main__":
    main()
