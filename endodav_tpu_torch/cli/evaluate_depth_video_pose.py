"""Video depth, pose and intrinsics benchmark on SCARED, served by the port.

Run as ``python -m endodav_tpu_torch.cli.evaluate_depth_video_pose
--load_weights_folder <log_dir>/endodav/models/weights_last [flags]``, the
second command of ``scripts/train_video.sh``: video depth with TAE/TAS on
the ``test_files.txt`` sequences of ``--eval_split`` (the alignment
summary, the metric line and the 95%-CI row), then per sequence the pose
network on consecutive frame pairs at the sequence's native resolution,
ATE and RE on 5-frame tracks with their CI, and under
``--learn_intrinsics`` the normalised intrinsics' mean and spread; the
lines of `endodav_tpu/cli/evaluate_depth_video_pose.py`.
"""

from __future__ import annotations

import os

from endodav_tpu_torch.cli.evaluate_depth_video import report
from endodav_tpu_torch.data.readers import readlines
from endodav_tpu_torch.data.scared import ScaredVideos
from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.options import EndoDAVOptions
from endodav_tpu_torch.parallel import run_cli


def evaluate(opt):
    filenames = readlines(os.path.join(engine.splits_dir(), opt.eval_split, "test_files.txt"))
    sequences = ScaredVideos(opt.data_path, filenames)
    device = engine.resolve_device(opt)
    forward = engine.depth_window_forward(engine.build_depth_model(opt, device), opt)
    depth = engine.evaluate_video_sequences(opt, sequences, forward, device=device)
    engine.print_alignment_summary(opt.depth_align, depth["ratios"], depth["align_stats"])
    print(report(depth)[0])
    engine.print_ci_row(depth["all_errors"], depth["all_temporal"])

    pose_results = []
    for data in sequences:
        # the pose network sees the sequence at its native resolution
        # (evaluate_depth_video_pose.py:256-262); --height/--width only
        # normalise the intrinsics statistics
        gt_local, pairs = engine.sequence_pose_pairs(data)
        res = engine.evaluate_pose_pairs(opt, gt_local, pairs, device=device)
        pose_results.append(res)
        print(f"{data['filename']}: ATE {res['ate_mean']:.4f}±{res['ate_std']:.4f} "
              f"[{res['ate_ci'][0]:.4f}, {res['ate_ci'][1]:.4f}] | RE "
              f"{res['re_mean']:.4f}±{res['re_std']:.4f}")
        if opt.learn_intrinsics:
            print("  " + " ".join(f"{k}: {v[0]:.4f}±{v[1]:.4f}"
                                  for k, v in res["intrinsics_stats"].items()))
    return {"depth": depth, "pose": pose_results}


def main(argv=None):
    return run_cli(evaluate, EndoDAVOptions().parse(argv), training=False)


if __name__ == "__main__":
    main()
