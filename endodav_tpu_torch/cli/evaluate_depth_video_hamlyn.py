"""Hamlyn full-sequence video depth benchmark, served by the port.

Port of `endodav_tpu/cli/evaluate_depth_video_hamlyn.py`
(evaluate_depth_video_hamlyn.py parity): the sequences of
``splits/hamlyn_video/val_files_all.txt`` (`data/hamlyn.py:HamlynVideos`,
``--max_length`` frames each), served through the depth model's window
forward on the card (``--no_cuda``: the CPU), or with ``--pred_root`` the
saved depth .npy files re-scored (``--disp2depth`` if they hold
disparities).  No poses, so no TAE/TAS.  Prints the alignment summary, the
metric line, the per-metric 95% CI row and the mean inference time;
``--visualize_depth`` writes each sequence's vis.mp4 and aligned depth .npy
files under ``<load_weights_folder>/eval/<eval_split>``.  ``--serve_mesh``
serves over ranks as `cli/evaluate_depth_video` does.

    python -m endodav_tpu_torch.cli.evaluate_depth_video_hamlyn --data_path <hamlyn> \
        --eval_split hamlyn_video --load_weights_folder <weights> --eval_mono \
        --visualize_depth --disable_residual_block --disable_conv_head --lora_type ssb
"""

from __future__ import annotations

import os

from endodav_tpu_torch.cli.evaluate_depth_video import save_folder
from endodav_tpu_torch.data.hamlyn import HamlynVideos
from endodav_tpu_torch.data.readers import readlines
from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.options import EndoDAVOptions
from endodav_tpu_torch.parallel import run_cli

HEADER = engine.METRIC_NAMES[:7]


def evaluate(opt):
    split_file = os.path.join(engine.splits_dir(), "hamlyn_video", "val_files_all.txt")
    sequences = HamlynVideos(opt.data_path, readlines(split_file), pred_root=opt.pred_root,
                             max_length=opt.max_length)
    device = engine.resolve_device(opt)
    forward = None
    if opt.pred_root is None:
        forward = engine.depth_window_forward(engine.build_depth_model(opt, device), opt)
    result = engine.evaluate_video_sequences(opt, sequences, forward, device=device,
                                             with_temporal=False, save_folder=save_folder(opt))
    # alignment summary + per-metric CI rows (evaluate_depth_video_hamlyn.py:228-258)
    engine.print_alignment_summary(opt.depth_align, result["ratios"], result["align_stats"])
    print(" | ".join(f"{n}={v:.4f}" for n, v in zip(HEADER, result["mean_errors"])))
    engine.print_ci_row(result["all_errors"])
    if result["mean_infer_ms"] is not None:
        print(f"average inference time: {result['mean_infer_ms']:.2f} ms/frame")
    return result


def main(argv=None):
    return run_cli(evaluate, EndoDAVOptions().parse(argv), training=False)


if __name__ == "__main__":
    main()
