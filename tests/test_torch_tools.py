"""The port's pose eval, GT export, visualisation, DepthCrafter scorer,
geometry extras, PoseCNN, the trainer's pose guards and mask decoder,
profiling and flags, against the JAX package on the CPU.

* `cli/export_gt` (depth in both ``--useage`` modes, pose) on a synthetic
  SCARED tree: the npz files bit for bit;
* `cli/evaluate_pose` on the same tree with JAX's weights folder: ATE, RE
  and their CI within 1e-5 relative (the pose nets' f32 sums reassociate),
  the predicted poses within 1e-5, the printed lines and ``pose_eval.txt``
  within one unit of their fourth decimal;
* `cli/visualize`: the point clouds and their PLY text equal, the
  reconstruction mode's files equal, a trajectory plot written;
* `eval/depthcrafter`: the alignment (per frame and ``temporal_fit``),
  every metric with TAE/TAS, and the csv and json reports, to 1e-12 (the
  same host arithmetic);
* `geometry/extras` within 1e-5 relative (`project_raw_pixels`: f32
  products) or exactly;
* `PoseCNN` and the ``--predictive_mask`` decoder through the weight
  bridge within 1e-5;
* the pose flags the video trainer refuses, with JAX's messages.

JAX's native image and TIFF decoders are switched off so that both read
through PIL and cv2.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# jax_folder and the jax_model fixture it uses
from test_torch_train_loop import jax_folder, jax_model  # noqa: F401
from test_torch_train_loop import ARGS, IMG_H, IMG_W, POSE_RTOL, jax_opt, port_opt

torch.set_num_threads(1)

SEQ1, SEQ2 = "dataset5/keyframe1", "dataset5/keyframe4"
N_POSE = 14  # frames a sequence
HOST_RTOL, MODEL_TOL = 1e-12, 1e-5


def _pose(i, k):
    """A w2c pose drifting and turning with the frame."""
    a = 0.02 * i + 0.1 * k
    c, s = np.cos(a), np.sin(a)
    p = np.eye(4)
    p[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    p[:3, 3] = [0.5 * i, -0.2 * i + k, 0.3 * i]
    return p


def write_pose_tree(root):
    """``<root>/data/train/<seq>/data/{left,scene_points,frame_data}`` for
    two sequences, and ``<root>/splits/endovis`` with the eval, pose and
    reconstruction lists."""
    import cv2

    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, IMG_H), np.linspace(0, 1, IMG_W), indexing="ij")
    for k, seq in enumerate((SEQ1, SEQ2)):
        base = os.path.join(root, "data", "train", seq, "data")
        for sub in ("left", "scene_points", "frame_data"):
            os.makedirs(os.path.join(base, sub))
        for i in range(N_POSE):
            img = np.stack([128 + 90 * np.sin(7 * xx + 5 * yy + 0.2 * i + c + k)
                            for c in range(3)], -1) + rng.uniform(-10, 10, (IMG_H, IMG_W, 3))
            cv2.imwrite(os.path.join(base, "left", f"{i:010d}.png"),
                        np.clip(img, 0, 255).astype(np.uint8))
            d = (40 + 30 * yy + 10 * np.cos(3 * xx + 0.05 * i + k)).astype(np.float32)
            cv2.imwrite(os.path.join(base, "scene_points", f"scene_points{i:06d}.tiff"),
                        np.stack([d, d + 1, d + 2], -1))
            with open(os.path.join(base, "frame_data", f"frame_data{i:06d}.json"), "w") as f:
                json.dump({"camera-pose": _pose(i, k).tolist()}, f)
    split = os.path.join(root, "splits", "endovis")
    os.makedirs(split)
    lines = {SEQ1: range(1, N_POSE - 1), SEQ2: range(1, N_POSE - 1)}
    for n, seq in enumerate((SEQ1, SEQ2), start=1):
        with open(os.path.join(split, f"test_files_sequence{n}.txt"), "w") as f:
            f.write("".join(f"{seq}\t{i}\tl\n" for i in lines[seq]))
    with open(os.path.join(split, "test_files.txt"), "w") as f:
        f.write("".join(f"{seq}\t{i}\tl\n" for seq in (SEQ1, SEQ2) for i in (1, 5, 9)))
    with open(os.path.join(split, "3d_reconstruction.txt"), "w") as f:
        f.write(f"{SEQ2}\t3\tl\n{SEQ1}\t7\tl\n")
    return root


@pytest.fixture(scope="module")
def pose_tree(tmp_path_factory):
    return write_pose_tree(str(tmp_path_factory.mktemp("pose_tree")))


@pytest.fixture
def split_dirs(pose_tree, tmp_path, monkeypatch):
    """A copy of the split directory for each package, named to it as each
    names its split directory; JAX reads through PIL and cv2."""
    from endodav_tpu import native
    from endodav_tpu.cli import export_gt as jexport
    from endodav_tpu.eval import engine as jengine

    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = str(tmp_path / f"splits_{side}")
        shutil.copytree(os.path.join(pose_tree, "splits"), dirs[side])
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jengine, "SPLITS_DIR", dirs["jax"])
    monkeypatch.setattr(jexport, "SPLITS_DIR", dirs["jax"])
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", dirs["port"])
    return dirs


@pytest.mark.parametrize("what,useage", [("depth", "eval"), ("depth", "3d_recon"),
                                         ("pose", "eval")])
def test_export_gt_matches_jax(pose_tree, split_dirs, what, useage):
    from endodav_tpu.cli import export_gt as jexport
    from endodav_tpu_torch.cli import export_gt

    args = ["--data_path", os.path.join(pose_tree, "data"), "--what", what, "--useage", useage]
    _jax_main(jexport.main, args)
    export_gt.main(args)
    names = ({"eval": ["gt_depths.npz"], "3d_recon": ["gt_depths_recon.npz"]}[useage]
             if what == "depth" else [f"curve/gt_poses_sequence{n}.npz" for n in (1, 2)])
    for name in names:
        got, want = (np.load(os.path.join(split_dirs[s], "endovis", name)) for s in ("port", "jax"))
        assert list(got) == list(want) == ["data"]
        assert got["data"].dtype == want["data"].dtype == np.float32
        assert got["data"].shape == want["data"].shape
        np.testing.assert_array_equal(got["data"], want["data"])


def _jax_main(main, args):
    """A JAX CLI's ``main()``, which reads ``sys.argv``, on ``args``."""
    argv = sys.argv
    sys.argv = ["cli", *args]
    try:
        main()
    finally:
        sys.argv = argv


def _numbers(text):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", text)]


def test_evaluate_pose_matches_jax(pose_tree, split_dirs, jax_folder, tmp_path,  # noqa: F811
                                   capsys):
    """``scripts/eval_pose.sh``'s command on both packages, after
    `export_gt --what pose`: the results, the npz and the report lines."""
    from endodav_tpu.cli import evaluate_pose as jcli
    from endodav_tpu.cli.export_gt import export_gt_pose as jexport_pose
    from endodav_tpu_torch.cli import evaluate_pose
    from endodav_tpu_torch.cli.export_gt import export_gt_pose

    data = os.path.join(pose_tree, "data")
    for n in (1, 2):
        jexport_pose(data, "endovis", n)
        export_gt_pose(data, "endovis", n)
    folders = {}
    for side in ("jax", "port"):
        folders[side] = str(tmp_path / f"weights_{side}")
        shutil.copytree(jax_folder, folders[side])
    args = ["--data_path", data, "--eval_mono", *ARGS]
    capsys.readouterr()
    want = jcli.evaluate(jax_opt(*args, "--load_weights_folder", folders["jax"]))
    jout = capsys.readouterr().out
    got = evaluate_pose.main(["--no_cuda", *args, "--load_weights_folder", folders["port"]])
    out = capsys.readouterr().out
    assert sorted(got) == sorted(want) == [1, 2]
    for n in (1, 2):
        assert got[n]["pred_poses"].shape == (N_POSE - 2, 4, 4)
        for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
            np.testing.assert_allclose(got[n][k], want[n][k], rtol=POSE_RTOL, err_msg=k)
        np.testing.assert_allclose(got[n]["ate_ci"], want[n]["ate_ci"], rtol=POSE_RTOL)
        saved = [np.load(os.path.join(split_dirs[s], "endovis", "curve",
                                      f"pred_poses_sequence{n}.npz"))["data"]
                 for s in ("port", "jax")]
        np.testing.assert_allclose(saved[0], saved[1], rtol=MODEL_TOL, atol=1e-7)
        np.testing.assert_array_equal(saved[0], got[n]["pred_poses"])
    report = [ln for ln in out.splitlines() if ln.startswith(("sq", "fx", "fy", "cx", "cy"))]
    jreport = [ln for ln in jout.splitlines() if ln.startswith(("sq", "fx", "fy", "cx", "cy"))]
    assert len(report) == len(jreport) == 8
    assert [re.sub(r"-?\d+\.\d+", "#", ln) for ln in report] == \
        [re.sub(r"-?\d+\.\d+", "#", ln) for ln in jreport]
    np.testing.assert_allclose(_numbers("\n".join(report)), _numbers("\n".join(jreport)),
                               atol=1.5e-4)
    texts = [open(os.path.join(folders[s], "pose_eval.txt")).read() for s in ("port", "jax")]
    np.testing.assert_allclose(_numbers(texts[0]), _numbers(texts[1]), atol=1.5e-4)


# ------------------------------------------------------------ visualize


def test_pointcloud_and_ply_match_jax(tmp_path):
    from endodav_tpu.cli import visualize as jvis
    from endodav_tpu_torch.cli import visualize

    rng = np.random.default_rng(3)
    color = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    depth = rng.uniform(1, 50, (12, 16)).astype(np.float32)
    depth[3:5] = 0  # invalid pixels drop out
    K = np.array([[14.0, 0, 8.2], [0, 11.0, 6.1], [0, 0, 1]])
    got, want = visualize.depth_to_pointcloud(color, depth, K), jvis.depth_to_pointcloud(
        color, depth, K)
    assert got[0].shape == (12 * 16 - 32, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    visualize.save_pointcloud(str(tmp_path / "port"), *got)
    jvis.save_pointcloud(str(tmp_path / "jax"), *want)
    assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()


def test_reconstruction_mode_matches_jax(pose_tree, split_dirs, tmp_path):
    """``--mode reconstruction``: saved depth npys of a sequence and its
    left frames -> one PLY a frame, the same text as JAX's."""
    from endodav_tpu.cli import visualize as jvis
    from endodav_tpu_torch.cli import visualize

    pred_root = tmp_path / "pred"
    seq = f"train/{SEQ1}"
    os.makedirs(pred_root / seq / "depth")
    rng = np.random.default_rng(5)
    for i in range(4):
        np.save(pred_root / seq / "depth" / f"{i:06d}.npy",
                rng.uniform(5, 60, (IMG_H, IMG_W)).astype(np.float32))
    args = ["--mode", "reconstruction", "--data_path", os.path.join(pose_tree, "data"),
            "--pred_root", str(pred_root), "--sequence", seq, "--max_frames", "3"]
    visualize.main([*args, "--out", str(tmp_path / "port")])
    _jax_main(jvis.main, [*args, "--out", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [f"{i:06d}.ply" for i in range(3)]
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_pose_mode_writes_a_plot(tmp_path):
    pytest.importorskip("matplotlib")
    from endodav_tpu_torch.cli import visualize

    poses = np.stack([np.linalg.inv(_pose(i + 1, 0)) @ _pose(i, 0) for i in range(8)])
    np.savez(tmp_path / "gt.npz", data=poses.astype(np.float32))
    np.savez(tmp_path / "pred.npz", data=(poses * 1.01).astype(np.float32))
    out = tmp_path / "traj.png"
    visualize.main(["--mode", "pose", "--pred_poses", str(tmp_path / "pred.npz"),
                    "--gt_poses", str(tmp_path / "gt.npz"), "--out", str(out)])
    assert out.stat().st_size > 10_000


def test_trajectory_points_match_jax_plot():
    """The points `plot_trajectories` draws, as JAX's plot computes them
    (`endodav_tpu/cli/visualize.py:57-65`, through JAX's metrics)."""
    from endodav_tpu.eval.metrics import compute_pose_scale, dump_poses
    from endodav_tpu_torch.cli import visualize

    gt = np.stack([np.linalg.inv(_pose(i + 1, 0)) @ _pose(i, 0) for i in range(8)])
    pred = gt.copy()
    pred[:, :3, 3] *= 0.7
    pred = pred[:7].astype(np.float32)
    got_gt, got_pred = visualize.trajectory_points(pred, gt)
    jgt, jpred = np.array(dump_poses(gt[:7])), np.array(dump_poses(pred))
    jpred = jpred * compute_pose_scale(jgt, jpred)
    origin = np.array([[0.0], [0.0], [0.0], [1.0]])
    np.testing.assert_array_equal(got_gt, np.stack([m @ origin for m in jgt])[:, :3, 0])
    np.testing.assert_array_equal(got_pred, np.stack([m @ origin for m in jpred])[:, :3, 0])
    assert got_gt.shape == (8, 3)  # the origin and one point a pose


# --------------------------------------------------------- depthcrafter


def _crafter_inputs():
    rng = np.random.default_rng(11)
    n, h, w = 5, 16, 20
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    gt = np.stack([20 + 10 * np.sin(0.3 * xx + 0.2 * yy + 0.1 * i) for i in range(n)])
    gt[:, :2] = 0  # invalid rows
    pred = 1.0 / np.clip(gt, 1, None) * 3.0 + 0.01 + rng.normal(0, 1e-3, gt.shape)
    K = np.array([[18.0, 0, 10, 0], [0, 16.0, 8, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    i2l = np.stack([np.linalg.inv(K @ _pose(i, 0)) for i in range(n)])
    return pred.astype(np.float32), gt.astype(np.float32), i2l


@pytest.mark.parametrize("temporal_fit", [False, True])
def test_depthcrafter_scores_match_jax(temporal_fit, tmp_path):
    from endodav_tpu.eval import depthcrafter as jdc
    from endodav_tpu_torch.eval import depthcrafter as dc

    pred, gt, i2l = _crafter_inputs()
    mask = (gt > 0.1) & (gt < 150)
    np.testing.assert_allclose(dc.lstsq_disparity_alignment(pred, gt, mask, temporal_fit),
                               jdc.lstsq_disparity_alignment(pred, gt, mask, temporal_fit),
                               rtol=HOST_RTOL)
    metrics = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "silog", "d1", "d2", "d3",
               "tae", "tas")
    got = dc.score_batch(pred, gt, img2lidar=i2l, temporal_fit=temporal_fit,
                         eval_metrics=metrics)
    want = jdc.score_batch(pred, gt, img2lidar=i2l, temporal_fit=temporal_fit,
                           eval_metrics=metrics)
    assert got.keys() == want.keys() and got["num_sample"] == want["num_sample"] == 5
    for k in metrics:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=HOST_RTOL, err_msg=k)
    results = {"seq_a": got, "seq_b": dc.score_batch(pred[:3], gt[:3])}
    dc.write_reports(results, str(tmp_path / "port"))
    jdc.write_reports(results, str(tmp_path / "jax"))
    for name in ("results.json", "results.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


# ------------------------------------------------------ geometry extras


def test_geometry_extras_match_jax():
    from endodav_tpu.geometry import extras as jx
    from endodav_tpu_torch.geometry import extras as tx

    rng = np.random.default_rng(2)
    b, h, w = 2, 6, 8
    points = np.concatenate([rng.uniform(-1, 1, (b, 2, h * w)), rng.uniform(2, 5, (b, 1, h * w)),
                             np.ones((b, 1, h * w))], axis=1).astype(np.float32)
    K = np.stack([np.array([[9.0, 0, 4, 0], [0, 7.0, 3, 0], [0, 0, 1, 0], [0, 0, 0, 1]])] * b)
    T = np.stack([_pose(i, 1) for i in range(b)])
    K, T = K.astype(np.float32), T.astype(np.float32)
    got = tx.project_raw_pixels(*(torch.from_numpy(a) for a in (points, K, T)), h, w)
    want = jx.project_raw_pixels(*(jnp.asarray(a) for a in (points, K, T)), h, w)
    assert got.shape == (b, h, w, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL, atol=1e-6)
    flow = rng.normal(0, 2, (b, h, w, 2)).astype(np.float32)
    np.testing.assert_array_equal(tx.flow_match(torch.from_numpy(flow)).numpy(),
                                  np.asarray(jx.flow_match(jnp.asarray(flow))))
    rigid = flow + rng.normal(0, 1.5, flow.shape).astype(np.float32)
    got_mask = tx.texture_mask(torch.from_numpy(flow), torch.from_numpy(rigid)).numpy()
    want_mask = np.asarray(jx.texture_mask(jnp.asarray(flow), jnp.asarray(rigid)))
    assert 0 < got_mask.mean() < 1
    np.testing.assert_array_equal(got_mask, want_mask)


def test_reduced_ransac_matches_jax():
    from endodav_tpu.geometry import extras as jx
    from endodav_tpu_torch.geometry import extras as tx

    pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    b, h, w = 2, 12, 16
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flow = np.stack([np.stack([0.1 * yy + 0.02 * (k + 1) * xx, 0.05 * xx - 0.03 * yy + k], -1)
                     for k in range(b)])
    flow = flow + rng.normal(0, 0.01, flow.shape)
    match = np.asarray(jx.flow_match(jnp.asarray(flow.astype(np.float32))))
    scores = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    got = tx.reduced_ransac(torch.from_numpy(match), torch.from_numpy(scores),
                            rng=np.random.default_rng(1))
    want = jx.reduced_ransac(match, scores, rng=np.random.default_rng(1))
    assert got.shape == (b, 3, 3)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------- PoseCNN, the mask decoder


def test_posecnn_through_the_weight_bridge():
    from endodav_tpu.models.decoders import PoseCNN as JPoseCNN
    from endodav_tpu_torch.models.decoders import PoseCNN
    from endodav_tpu_torch.utils.convert import from_jax_params, to_jax_params
    from test_torch_lora_models import _weights

    x = np.random.default_rng(6).uniform(0, 1, (2, IMG_H, IMG_W, 6)).astype(np.float32)
    jm = JPoseCNN(num_input_frames=2)
    params = _weights(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 8)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    model = PoseCNN(num_input_frames=2)
    model.load_state_dict(from_jax_params(params, "decoder"), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, 1, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MODEL_TOL, atol=1e-7)
    back = to_jax_params(model.state_dict(), "decoder")["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_predictive_mask_decoder_through_the_weight_bridge(tmp_path):
    """``--predictive_mask`` builds JAX's DepthDecoder with len(frame_ids) - 1
    outputs; neither package's checkpoint carries it."""
    from endodav_tpu.train.trainer import build_models as jbuild, init_variables
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer
    from endodav_tpu_torch.utils.convert import from_jax_params
    from test_torch_lora_models import _weights
    from test_torch_train_step import FLAGS, _jax_opt

    jopt = _jax_opt()
    jopt.predictive_mask = True
    jmods = jbuild(jopt)
    assert "predictive_mask" not in init_variables(jmods, jopt)
    feats = [np.random.default_rng(c).uniform(0, 1, (1, 32 // 2 ** (i + 1), 64 // 2 ** (i + 1), c))
             .astype(np.float32) for i, c in enumerate((64, 64, 128, 256, 512))]
    jdec = jmods["predictive_mask"]
    params = _weights(jax.eval_shape(jdec.init, jax.random.PRNGKey(0),
                                     [jnp.asarray(f) for f in feats]), 12)["params"]
    want = jdec.apply({"params": params}, [jnp.asarray(f) for f in feats])
    trainer = Trainer(EndoDAVOptions().parse([*FLAGS, "--predictive_mask",
                                              "--log_dir", str(tmp_path)]))
    dec = trainer.mods["predictive_mask"]
    dec.load_state_dict(from_jax_params(params, "decoder"), strict=True)
    with torch.no_grad():
        got = dec([torch.from_numpy(f) for f in feats])
    for s in (0, 1, 2, 3):
        assert got[("disp", s)].shape == want[("disp", s)].shape
        assert got[("disp", s)].shape[-1] == 2
        np.testing.assert_allclose(got[("disp", s)].numpy(), np.asarray(want[("disp", s)]),
                                   rtol=MODEL_TOL, atol=1e-7)
    folder = trainer.save_model("last")
    assert sorted(f for f in os.listdir(folder) if f.endswith(".msgpack")) == sorted(
        [f"{k}.msgpack" for k in init_variables(jmods, jopt)] + ["adam.msgpack"])


@pytest.mark.parametrize("flag,value", [("pose_model_type", "posecnn"),
                                        ("pose_model_type", "shared"),
                                        ("pose_model_input", "all")])
def test_build_models_refuses_as_jax(flag, value):
    from endodav_tpu.train.trainer import build_models as jbuild
    from endodav_tpu_torch.train.trainer import build_models
    from test_torch_train_step import FLAGS

    opt = port_opt(*FLAGS[1:], f"--{flag}", value)
    jopt = jax_opt(*FLAGS[1:], f"--{flag}", value)
    with pytest.raises(ValueError) as want:
        jbuild(jopt)
    with pytest.raises(ValueError) as got:
        build_models(opt)
    assert str(got.value) == str(want.value)


# ------------------------------------------------- profiling, the flags


def test_profiling_on_the_cpu(tmp_path):
    from endodav_tpu_torch.utils.profiling import StageTimer, trace

    timer = StageTimer()
    assert not timer.sync  # nothing to wait for without a card
    with trace(None), timer.stage("noop"):
        pass
    with trace(str(tmp_path / "trace")), timer.stage("matmul"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert [f for f in os.listdir(tmp_path / "trace") if f.endswith(".json")]
    assert timer.counts == {"noop": 1, "matmul": 1}
    assert timer.summary().splitlines()[0].startswith(("matmul", "noop"))


def test_every_jax_flag_parses_with_its_default():
    """Every flag of JAX's `options.py`, the two mesh flags included, with
    JAX's default and choices; the shipped eval scripts' command lines and
    the mesh flags' values parse as in JAX."""
    from endodav_tpu.options import EndoDAVOptions as JOptions
    from endodav_tpu_torch.options import EndoDAVOptions

    port = {a.dest: a for a in EndoDAVOptions().parser._actions}
    jax_flags = {a.dest: a for a in JOptions().parser._actions}
    assert not set(jax_flags) - set(port)
    assert port["mesh_shape"].default == jax_flags["mesh_shape"].default == ""
    assert port["serve_mesh"].default == jax_flags["serve_mesh"].default == ""
    for dest, a in jax_flags.items():
        if dest in port and dest not in ("num_layers", "help"):
            assert (port[dest].default, port[dest].choices, port[dest].nargs) == (
                a.default, a.choices, a.nargs), dest
    line = ["--model_type", "endodav", "--data_path", "/h", "--eval_split", "hamlyn_video",
            "--load_weights_folder", "/w", "--eval_mono", "--visualize_depth",
            "--disable_residual_block", "--disable_conv_head", "--lora_type=ssb",
            "--max_length", "32", "--pose_model_type", "posecnn", "--use_dp", "--png"]
    got, want = vars(EndoDAVOptions().parse(line)), vars(JOptions().parse(line))
    for k, v in want.items():
        assert got[k] == v, k
    mesh = ["--mesh_shape", "data=2", "--serve_mesh", "model=2"]
    got, want = vars(EndoDAVOptions().parse(mesh)), vars(JOptions().parse(mesh))
    assert (got["mesh_shape"], got["serve_mesh"]) == (want["mesh_shape"], want["serve_mesh"])
