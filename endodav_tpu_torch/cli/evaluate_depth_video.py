"""Video depth benchmark on SCARED, served by the port.

Run as ``python -m endodav_tpu_torch.cli.evaluate_depth_video --data_path
<tree> [flags]``: builds the depth model from the flags, runs batched
sliding-window inference per sequence (``--model_type endodav``) or
frame-independent inference in batches of 8 (``endodac``, ``afsfm``: the
paper's single-frame baselines), aligns, and prints the per-frame depth
errors with TAE/TAS, the abs_rel 95% CI and the mean inference time per
frame — the same lines as `endodav_tpu`'s CLI.
"""

from __future__ import annotations

import os

import numpy as np

from endodav_tpu_torch.data.readers import readlines
from endodav_tpu_torch.data.scared import ScaredVideos
from endodav_tpu_torch.eval import engine
from endodav_tpu_torch.options import EndoDAVOptions


def report(result) -> list[str]:
    """The metric lines the CLI prints for an `evaluate_video_sequences` result."""
    temporal = result["mean_temporal"] if result["mean_temporal"] is not None else [np.nan] * 2
    vals = list(result["mean_errors"]) + list(temporal)
    ci = result["ci"]
    lines = [" | ".join(f"{n}={v:.4f}" for n, v in zip(engine.METRIC_NAMES, vals)),
             f"abs_rel 95% CI: [{ci[0]:.4f}, {ci[1]:.4f}]"]
    if result["mean_infer_ms"] is not None:
        lines.append(f"average inference time: {result['mean_infer_ms']:.2f} ms/frame")
    return lines


def evaluate(opt):
    if opt.visualize_depth and opt.load_weights_folder:
        raise NotImplementedError("--visualize_depth (the depth images JAX's CLI writes under "
                                  "<load_weights_folder>/eval) is not ported")
    filenames = readlines(os.path.join(engine.splits_dir(), opt.eval_split, "val_files.txt"))
    sequences = ScaredVideos(opt.data_path, filenames, pred_root=opt.pred_root)
    device = engine.resolve_device(opt)
    forward = None
    if opt.pred_root is None:
        forward = engine.depth_window_forward(engine.build_depth_model(opt, device))
    result = engine.evaluate_video_sequences(opt, sequences, forward, device=device)
    lines = report(result)
    print("\n".join(lines))
    if opt.load_weights_folder:
        out = os.path.join(os.path.dirname(os.path.expanduser(opt.load_weights_folder)),
                           "results.txt")
        with open(out, "a") as f:
            f.write(lines[0] + "\n")
    return result


def main():
    evaluate(EndoDAVOptions().parse())


if __name__ == "__main__":
    main()
