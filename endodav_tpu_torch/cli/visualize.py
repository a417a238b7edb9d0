"""Trajectory plots and point clouds, on the host.

Port of `endodav_tpu/cli/visualize.py` (visualize_pose.py /
visualize_reconstruction.py parity):
``python -m endodav_tpu_torch.cli.visualize --mode pose --pred_poses
<npz> --gt_poses <npz> --out <png>`` draws the ground-truth and predicted
trajectories (the npz files `cli/evaluate_pose` and `cli/export_gt` write);
``--mode reconstruction --data_path <tree> --pred_root <root> --sequence
<seq> --out <dir>`` writes one point cloud a frame from the saved depth
.npy files (`--visualize_depth`) and the sequence's left frames.  Point
clouds go through open3d where it imports, else as ASCII PLY text.
`save_depth_video` writes the rgb | inferno-depth mp4 of
``--visualize_depth`` (imageio and matplotlib).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

__all__ = ["depth_to_pointcloud", "save_pointcloud", "trajectory_points", "plot_trajectories",
           "save_depth_video", "main"]


def depth_to_pointcloud(color: np.ndarray, depth: np.ndarray, K: np.ndarray):
    """[H,W,3] uint8 + [H,W] depth + K[3x3] -> (points [N,3], colors [N,3])."""
    h, w = depth.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth.reshape(-1)
    valid = z > 1e-6
    x = (xs.reshape(-1) - K[0, 2]) / K[0, 0] * z
    y = (ys.reshape(-1) - K[1, 2]) / K[1, 1] * z
    pts = np.stack([x, y, z], axis=-1)[valid]
    cols = color.reshape(-1, 3)[valid]
    return pts, cols


def save_pointcloud(path: str, points: np.ndarray, colors: np.ndarray):
    """``path`` (``.ply`` added if missing) through open3d, or as ASCII PLY."""
    out = path if path.endswith(".ply") else path + ".ply"
    try:
        import open3d as o3d
    except ImportError:
        o3d = None
    if o3d is not None:
        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(points)
        pc.colors = o3d.utility.Vector3dVector(colors.astype(np.float64) / 255.0)
        o3d.io.write_point_cloud(out, pc)
        return
    with open(out, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\nend_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {int(c[0])} {int(c[1])} {int(c[2])}\n")


def trajectory_points(pred_local_poses: np.ndarray, gt_local_poses: np.ndarray):
    """The GT and the scale-aligned predicted camera positions [n, 3] that
    `plot_trajectories` draws, from relative poses [n, 4, 4]."""
    from endodav_tpu_torch.eval.metrics import compute_pose_scale, dump_poses

    n = min(len(gt_local_poses), len(pred_local_poses))
    gt = np.array(dump_poses(gt_local_poses[:n]))
    pred = np.array(dump_poses(pred_local_poses[:n]))
    pred = pred * compute_pose_scale(gt, pred)
    origin = np.array([[0.0], [0.0], [0.0], [1.0]])
    return (np.stack([m @ origin for m in gt])[:, :3, 0],
            np.stack([m @ origin for m in pred])[:, :3, 0])


def plot_trajectories(pred_local_poses: np.ndarray, gt_local_poses: np.ndarray, save_path: str):
    """3D GT-vs-pred trajectory plot (visualize_pose.py / vis_pose_sq); needs
    matplotlib, as JAX's."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts_gt, pts_pred = trajectory_points(pred_local_poses, gt_local_poses)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("y [mm]")
    ax.set_zlabel("z [mm]")
    ax.plot(pts_gt[:, 0], pts_gt[:, 1], pts_gt[:, 2], c="b", label="GT", linewidth=1.6)
    ax.plot(pts_pred[:, 0], pts_pred[:, 1], pts_pred[:, 2], c="g", label="Prediction",
            linewidth=1.6)
    plt.legend()
    plt.savefig(save_path, dpi=600)
    plt.close(fig)


def save_depth_video(rgbs: np.ndarray, depths: np.ndarray, path: str, fps: int = 25):
    """Side-by-side rgb | inferno-depth mp4 (eval_utils.py:284-295)."""
    import imageio.v2 as imageio
    import matplotlib.cm as cm

    writer = imageio.get_writer(path, fps=fps, macro_block_size=1)
    colormap = np.array(cm.get_cmap("inferno").colors)
    d_min, d_max = depths.min(), depths.max()
    for i in range(len(depths)):
        dn = ((depths[i] - d_min) / (d_max - d_min + 1e-6) * 255).astype(np.uint8)
        dv = (colormap[dn] * 255).astype(np.uint8)
        writer.append_data(np.concatenate([rgbs[i].astype(np.uint8), dv], axis=1))
    writer.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["pose", "reconstruction"], required=True)
    p.add_argument("--pred_poses", type=str, help="npz with predicted relative poses")
    p.add_argument("--gt_poses", type=str, help="npz with GT relative poses")
    p.add_argument("--data_path", type=str, help="dataset root (reconstruction mode)")
    p.add_argument("--pred_root", type=str, help="saved depth npys root (reconstruction mode)")
    p.add_argument("--sequence", type=str, default=None,
                   help="split-relative sequence dir, e.g. train/dataset5/keyframe1")
    p.add_argument("--max_frames", type=int, default=10)
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)
    if args.mode == "pose":
        pred = np.load(args.pred_poses)["data"]
        gt = np.load(args.gt_poses)["data"]
        plot_trajectories(pred, gt, args.out)
        print(f"saved trajectory plot to {args.out}")
        return
    # RGBD -> point cloud per frame (visualize_reconstruction.py:50-100)
    from endodav_tpu_torch.data.pipeline import NORMALIZED_K
    from endodav_tpu_torch.data.readers import list_frames, read_image

    paths = list_frames(os.path.join(args.data_path, args.sequence))
    depth_files = sorted(glob.glob(os.path.join(args.pred_root, args.sequence, "depth", "*.npy")))
    os.makedirs(args.out, exist_ok=True)
    for i, (img_path, d_path) in enumerate(zip(paths["left"], depth_files)):
        if i >= args.max_frames:
            break
        color = read_image(img_path)
        depth = np.load(d_path)
        h, w = depth.shape
        K = NORMALIZED_K[:3, :3].copy()
        K[0] *= w
        K[1] *= h
        pts, cols = depth_to_pointcloud(color, depth, K)
        save_pointcloud(os.path.join(args.out, f"{i:06d}.ply"), pts, cols)
    print(f"saved point clouds to {args.out}")


if __name__ == "__main__":
    main()
