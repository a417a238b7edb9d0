"""The port's training loop against the JAX package on the CPU: the clip
dataset's host and random_train layouts, `validation_ncc`, the batched
TAE/TAS (`eval/metrics_device.py`), `evaluate_pose_pairs`, the epoch eval
(`Trainer.run_epoch_eval`) and `cli/evaluate_depth_video_pose.evaluate`, on
a small synthetic SCARED tree (64x96 frames, training at 64x96 with T=4, the
ViT at 28x42, the full 12-block vits with the shipped ssb flags), and the
port's `train()` writing its checkpoints, its options and one results line.

Both packages read the tree through PIL and cv2 (JAX's native decoder
patched off).  The JAX depth model runs its TPU serving route (the fused
temporal block in Pallas's interpreter), as the port serves.  Weights are
JAX's init trees filled from numpy seeds (`random_variables`) and reach the
port through a JAX-written checkpoint folder (`utils/checkpoint.py`).

Tolerances: items of the dataset exactly as JAX's (both resize through the
same numpy matrices); `validation_ncc` within 1e-5; TAE and TAS on identical
depths within 1e-6; pose ATE, RE and intrinsics statistics within 1e-5
relative (1e-4 through a whole eval); depth metrics of a whole eval within
1e-4 relative; TAE and TAS of a whole eval within 5% (each depth map is
reprojected to whole pixels of the next, so a 2e-6 change of depth moves
TAE by up to 3%).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

SEQ_TRAIN, SEQ_VAL = "train/dataset1/keyframe1", "train/dataset5/keyframe1"
N_FRAMES, IMG_H, IMG_W = 24, 64, 96
# scripts/train_video.sh's model flags at a small size
ARGS = ["--height", "64", "--width", "96", "--T", "4", "--batch_size", "1",
        "--depth_image_shape", "28", "42", "--lora_type", "ssb", "--disable_residual_block",
        "--disable_conv_head", "--depth_reproj", "1e-2", "--num_workers", "1"]
TRAIN_ARGS = [*ARGS, "--temporal_lora"]
COMPONENTS = ("depth_model", "position_encoder", "position", "transform_encoder", "transform",
              "pose_encoder", "pose", "intrinsics_head")
METRIC_RTOL, POSE_RTOL, TEMPORAL_RTOL = 1e-4, 1e-5, 5e-2


def write_tree(root, n=N_FRAMES, h=IMG_H, w=IMG_W):
    """One training and one val sequence of smooth drifting frames (PNG),
    the val one with depths (3-channel float TIFF) and poses (JSON), and a
    split directory whose val and test files name the val sequence."""
    import cv2

    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    for k, seq in enumerate((SEQ_TRAIN, SEQ_VAL)):
        base = os.path.join(root, "data", seq, "data")
        for sub in ("left", "scene_points", "frame_data"):
            os.makedirs(os.path.join(base, sub))
        for i in range(n):
            img = np.stack([128 + 90 * np.sin(7 * xx + 5 * yy + 0.1 * i + c + k)
                            for c in range(3)], -1) + rng.uniform(-10, 10, (h, w, 3))
            cv2.imwrite(os.path.join(base, "left", f"{i:010d}.png"),
                        np.clip(img, 0, 255).astype(np.uint8))
            d = (40 + 30 * yy + 10 * np.cos(3 * xx + 0.05 * i)).astype(np.float32)
            cv2.imwrite(os.path.join(base, "scene_points", f"scene_points{i:06d}.tiff"),
                        np.stack([d, d, d], -1))
            pose = np.eye(4)
            pose[0, 3], pose[2, 3] = 0.5 * i, 0.2 * i
            with open(os.path.join(base, "frame_data", f"frame_data{i:06d}.json"), "w") as f:
                json.dump({"camera-pose": pose.tolist()}, f)
    split = os.path.join(root, "splits", "scared_video")
    os.makedirs(split)
    for name, seq in (("train", SEQ_TRAIN), ("val", SEQ_VAL), ("test", SEQ_VAL)):
        with open(os.path.join(split, f"{name}_files.txt"), "w") as f:
            f.write(seq + "\n")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("scared_train")))


@pytest.fixture
def both_read(tree, monkeypatch):
    """Both packages on the tree's split directory, JAX through PIL."""
    from endodav_tpu import native
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.train import trainer as jtrainer

    splits = os.path.join(tree, "splits")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jengine, "SPLITS_DIR", splits)
    monkeypatch.setattr(jtrainer, "SPLITS_DIR", splits)
    monkeypatch.setenv("ENDODAV_TPU_SPLITS_DIR", splits)
    return os.path.join(tree, "data")


def jax_opt(*args):
    from endodav_tpu.options import EndoDAVOptions as JOptions

    return JOptions().parse(list(args))


def port_opt(*args):
    from endodav_tpu_torch.options import EndoDAVOptions

    return EndoDAVOptions().parse(["--no_cuda", *args])


def random_variables(variables, seed):
    """JAX variables filled from a numpy seed: the params as
    `test_torch_lora_models._weights` fills them (fan-in scaled kernels,
    ssb's vectors near 1), BatchNorm means N(0, 0.1) and variances
    U(0.5, 1.5)."""
    from test_torch_lora_models import _weights

    rng = np.random.default_rng(seed + 1)
    out = {"params": _weights(variables["params"], seed)}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if jax.tree_util.keystr(p).endswith(
                "'var']") else 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
            variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def jax_model():
    """JAX's eight components at the training flags and their variables,
    filled from seeds."""
    from endodav_tpu.train.trainer import build_models, init_variables

    opt = jax_opt("--data_path", "/nonexistent", *TRAIN_ARGS)
    mods = build_models(opt)
    init = init_variables(mods, opt)
    variables = {k: random_variables(jax.tree_util.tree_map(np.asarray, init[k]), seed=i)
                 for i, k in enumerate(COMPONENTS)}
    return mods, variables


@pytest.fixture(scope="module")
def jax_folder(jax_model, tmp_path_factory):
    """A weights folder written by JAX's `save_components`."""
    from endodav_tpu.utils import checkpoint as jckpt

    folder = str(tmp_path_factory.mktemp("jax_weights"))
    jckpt.save_components(folder, jax_model[1], metadata={
        "height": IMG_H, "width": IMG_W, "use_stereo": False, "dash_phase2": False})
    return folder


@pytest.fixture
def tpu_route():
    from test_torch_lora_models import tpu_route as route

    with route():
        yield


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("layout", ["host_train", "host_val", "host_random_train",
                                    "random_capable", "random_capable_random_train"])
def test_clip_items_match_jax(both_read, layout):
    """`ScaredVideoClips` items of every layout equal JAX's for the same
    seed, epoch and index: keys, shapes and values."""
    from endodav_tpu.data.scared import ScaredVideoClips as JClips
    from endodav_tpu_torch.data.scared import ScaredVideoClips

    kw = dict(is_train=layout != "host_val", T=4, device_preprocess=layout.startswith("random"),
              random_capable=layout.startswith("random"))
    items = []
    for cls in (JClips, ScaredVideoClips):
        ds = cls(both_read, [SEQ_TRAIN, SEQ_VAL], 64, 96, (0, -1, 1), 4, **kw)
        ds.epoch = 2
        ds.random_train = layout.endswith("random_train")
        assert len(ds) == 9
        items.append([ds[i] for i in (0, 5)])
    for want, got in zip(*items):
        assert sorted(map(str, want)) == sorted(map(str, got))
        if layout == "host_val":
            assert got["depth_gt"].shape == (4, IMG_H, IMG_W, 1)
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=str(k))


# ---------------------------------------------------------- val score


def test_validation_ncc_matches_jax():
    from endodav_tpu.train.losses import validation_ncc as jncc
    from endodav_tpu_torch.train.losses import validation_ncc

    rng = np.random.default_rng(3)
    scales = (0, 1, 2, 3)
    outputs = {("registration", s, f): rng.uniform(0, 1, (4, 32, 48, 3)).astype(np.float32)
               for s in scales for f in (-1, 1)}
    batch = {("color", 0, 0): rng.uniform(0, 1, (4, 32, 48, 3)).astype(np.float32)}
    want = float(jncc({k: jnp.asarray(v) for k, v in outputs.items()},
                      {k: jnp.asarray(v) for k, v in batch.items()}, scales))
    got = float(validation_ncc({k: torch.from_numpy(v) for k, v in outputs.items()},
                               {k: torch.from_numpy(v) for k, v in batch.items()}, scales))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


# ---------------------------------------------------------- TAE / TAS


def _sequence_with_ties(n=7, h=24, w=30):
    """Smooth depths with noise, and a camera moving away and sideways, so
    that several points land on one target pixel."""
    rng = np.random.default_rng(5)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    d = np.stack([40 + 30 * yy + 10 * np.cos(3 * xx + 0.3 * i) + rng.normal(0, 2, (h, w))
                  for i in range(n)])
    d = d.astype(np.float32)
    masks = d > 42
    K = np.array([[20, 0, 15, 0], [0, 20, 12, 0], [0, 0, 1, 0], [0, 0, 0, 1]], float)
    i2l = []
    for i in range(n):
        pose = np.eye(4)
        pose[0, 3], pose[1, 3], pose[2, 3] = 0.8 * i, -0.3 * i, 6.0 * i
        i2l.append(np.linalg.inv(K @ pose))
    return d, masks, np.stack(i2l)


def test_temporal_metrics_sequence_matches_jax_and_host():
    """The port's batched TAE/TAS (pairs split over passes of 4) against
    JAX's `metrics_device` and the host `metrics.tae`/`tas` pair by pair,
    on a splat with ties."""
    from endodav_tpu.eval import metrics as JM
    from endodav_tpu.eval.metrics_device import temporal_metrics_sequence as jtms
    from endodav_tpu_torch.eval.metrics_device import temporal_metrics_sequence

    d, m, i2l = _sequence_with_ties()
    h, w = d.shape[1:]
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    pts = np.stack([xs * d[0], ys * d[0], d[0], np.ones((h, w))], -1)[m[0]]
    pts = pts @ i2l[0].T @ np.linalg.inv(i2l[1]).T
    pix = np.round(pts[:, :2] / pts[:, 2:3])
    assert len(np.unique(pix, axis=0)) < len(pix)  # ties: points share target pixels
    got = temporal_metrics_sequence(d, m, i2l, pairs_per_pass=4)
    want = jtms(d, m, i2l)
    host = np.mean([(JM.tae(d[i - 1], m[i - 1], i2l[i - 1], d[i], m[i], i2l[i]),
                     JM.tas(d[i - 1], m[i - 1], i2l[i - 1], d[i], m[i], i2l[i]))
                    for i in range(1, len(d))], axis=0)
    assert 0 < want[1] < 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- pose


def _port_components(variables, names):
    """The port's components with JAX ``variables`` loaded, in eval mode."""
    from endodav_tpu_torch.train.trainer import build_models
    from endodav_tpu_torch.utils.checkpoint import load_variables

    mods = build_models(port_opt("--data_path", "/nonexistent", *TRAIN_ARGS))
    for name in names:
        load_variables(name, mods[name], variables[name])
    return {n: mods[n].eval() for n in names}


def test_evaluate_pose_pairs_matches_jax(jax_model):
    """21 pairs (a batch of 16 and a ragged 5): ATE, RE and the intrinsics
    statistics within 1e-5 relative of JAX's."""
    from endodav_tpu.eval.engine import evaluate_pose_pairs as jpose
    from endodav_tpu_torch.eval.engine import evaluate_pose_pairs

    mods, variables = jax_model
    rng = np.random.default_rng(7)
    pairs = rng.uniform(0, 1, (21, IMG_H, IMG_W, 6)).astype(np.float32)
    gt = np.stack([np.eye(4, dtype=np.float32)] * 21)
    gt[:, :3, 3] = rng.normal(0, 0.01, (21, 3))
    opt = port_opt("--data_path", "/nonexistent", *ARGS)
    names = ("pose_encoder", "pose", "intrinsics_head")
    want = jpose(jax_opt(*ARGS), gt, pairs, pose_modules=tuple(
        x for n in names for x in (mods[n], variables[n])))
    pm = _port_components(variables, names)
    got = evaluate_pose_pairs(opt, gt, pairs, pose_modules=tuple(pm[n] for n in names))
    assert got["pred_poses"].shape == (21, 4, 4)
    for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=POSE_RTOL, err_msg=k)
    for k, v in want["intrinsics_stats"].items():
        np.testing.assert_allclose(got["intrinsics_stats"][k], v, rtol=POSE_RTOL, err_msg=k)


# ------------------------------------------------------------ the eval


def _recording(monkeypatch, module, name, log):
    real = getattr(module, name)

    def record(*a, **k):
        out = real(*a, **k)
        log.append(out)
        return out

    monkeypatch.setattr(module, name, record)


def test_run_epoch_eval_matches_jax(both_read, jax_model, jax_folder, tpu_route, tmp_path,
                                    monkeypatch):
    """`Trainer.run_epoch_eval` on the JAX weights (loaded from JAX's
    folder) against JAX's `run_epoch_eval` on a stand-in of its trainer:
    the mean depth metrics within 1e-4 relative, TAE and TAS within 5%,
    ATE and RE within 1e-4 relative; one results line."""
    from endodav_tpu.data.scared import ScaredVideos as JVideos
    from endodav_tpu.eval import engine as jengine
    from endodav_tpu.eval import metrics as JM
    from endodav_tpu.eval import metrics_device as jmd
    from endodav_tpu.train.trainer import Trainer as JTrainer
    from endodav_tpu_torch.train.trainer import Trainer

    mods, variables = jax_model
    errors, temporal, pose = [], [], []
    _recording(monkeypatch, JM, "compute_errors", errors)
    _recording(monkeypatch, jmd, "temporal_metrics_sequence", temporal)
    _recording(monkeypatch, jengine, "evaluate_pose_pairs", pose)
    stand_in = types.SimpleNamespace(
        opt=jax_opt("--data_path", both_read, *TRAIN_ARGS), mods=mods, variables=variables,
        test_sequences=JVideos(both_read, [SEQ_VAL]), writers={},
        log_path=str(tmp_path / "jax"), epoch=1)
    JTrainer.run_epoch_eval(stand_in)

    t = Trainer(port_opt("--data_path", both_read, "--log_dir", str(tmp_path / "port"),
                         "--load_weights_folder", jax_folder, "--models_to_load",
                         *COMPONENTS, *TRAIN_ARGS))
    t.epoch = 1
    rmse, a1 = t.run_epoch_eval()
    got = t.eval_results
    want_depth = np.array([e for e in errors if not np.isnan(e).all()]).mean(0)
    assert len(errors) == N_FRAMES
    np.testing.assert_allclose(got["values"][:7], want_depth, rtol=METRIC_RTOL)
    np.testing.assert_allclose((rmse, a1), want_depth[[2, 4]], rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["values"][7:], [temporal[0][0] * 100, temporal[0][1]],
                               rtol=TEMPORAL_RTOL)
    for k in ("ate_mean", "re_mean"):
        np.testing.assert_allclose(got["pose"][0][k], pose[0][k], rtol=METRIC_RTOL, err_msg=k)
    lines = open(tmp_path / "port" / "endodav" / "models" / "results.txt").read().splitlines()
    assert lines[0].startswith("Epoch 01: ") and lines[1].startswith(f"  {SEQ_VAL}: ATE ")


def test_evaluate_depth_video_pose_cli_matches_jax(both_read, jax_folder, tpu_route):
    """`cli/evaluate_depth_video_pose.evaluate` against JAX's on JAX's
    folder with `scripts/train_video.sh`'s eval flags (no
    ``--temporal_lora``: both load the depth model by its own keys and
    leave the motion modules' adapters out): per-frame depth errors within
    1e-4 relative, TAE and TAS within 5%, ATE, RE and intrinsics within
    1e-4 relative."""
    from endodav_tpu.cli import evaluate_depth_video_pose as jcli
    from endodav_tpu_torch.cli import evaluate_depth_video_pose as cli

    args = ["--data_path", both_read, "--load_weights_folder", jax_folder, "--eval_mono",
            "--eval_split", "scared_video", *ARGS]
    want = jcli.evaluate(jax_opt(*args))
    got = cli.evaluate(port_opt(*args))
    assert got["depth"]["all_errors"].shape == (N_FRAMES, 7)
    np.testing.assert_allclose(got["depth"]["all_errors"], want["depth"]["all_errors"],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["depth"]["mean_temporal"], want["depth"]["mean_temporal"],
                               rtol=TEMPORAL_RTOL)
    (g,), (w,) = got["pose"], want["pose"]
    for k in ("ate_mean", "ate_std", "re_mean", "re_std"):
        np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, err_msg=k)
    for k, v in w["intrinsics_stats"].items():
        np.testing.assert_allclose(g["intrinsics_stats"][k], v, rtol=METRIC_RTOL, err_msg=k)


# ------------------------------------------------------------ training


def test_train_writes_checkpoints_and_results(both_read, tmp_path):
    """`python -m endodav_tpu_torch.cli.train_end_to_end_video` for one
    epoch (3 steps, val every 2 batches): ``weights_1/`` and
    ``weights_last/`` with the 8 components, the metadata and
    ``adam.msgpack``, ``opt.json`` and one results line."""
    from endodav_tpu_torch.cli import train_end_to_end_video
    from endodav_tpu_torch.utils.checkpoint import load_metadata

    log = tmp_path / "log"
    t = train_end_to_end_video.main(["--no_cuda", "--data_path", both_read, "--log_dir",
                                     str(log), "--num_epochs", "1", "--log_frequency", "2",
                                     *TRAIN_ARGS])
    assert t.step == 4 and len(t.train_loader) == 3
    models = log / "endodav" / "models"
    for folder in ("weights_1", "weights_last"):
        files = sorted(os.listdir(models / folder))
        assert files == sorted([f"{c}.msgpack" for c in COMPONENTS]
                               + ["adam.msgpack", "depth_model.msgpack.meta.json"])
        assert load_metadata(str(models / folder / "depth_model.msgpack")) == {
            "height": 64, "width": 96, "use_stereo": False, "dash_phase2": False}
    opts = json.load(open(models / "opt.json"))
    assert opts["lora_type"] == "ssb" and opts["T"] == 4
    lines = open(models / "results.txt").read().splitlines()
    assert sum(line.startswith("Epoch ") for line in lines) == 1
    assert np.isfinite([float(v) for v in lines[0].split(":")[1].split()]).all()


def test_step_after_val_is_bit_identical(both_read, tmp_path):
    """`val` and the epoch eval between two steps change nothing a step
    reads (BatchNorm's running statistics are read, not committed; the
    modules' modes come back): two trainers from the same seed take the
    same batches, one with a `val` and a `run_epoch_eval` between them,
    and end with every parameter and buffer bit for bit equal, and equal
    losses."""
    from endodav_tpu_torch.train.trainer import Trainer

    opt = port_opt("--data_path", both_read, "--log_dir", str(tmp_path), *TRAIN_ARGS)
    a, b = Trainer(opt), Trainer(opt)
    batch = next(iter(a.train_loader))
    for t in (a, b):
        t.train_one_batch(batch)
    score = a.val()
    rmse, _ = a.run_epoch_eval()
    assert np.isfinite([score, rmse]).all()
    assert all(m.training for m in a.mods.values())
    la, lb = a.train_one_batch(batch), b.train_one_batch(batch)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    for name in a.mods:
        sa, sb = a.mods[name].state_dict(), b.mods[name].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


@pytest.mark.parametrize("random_train", [False, True])
def test_host_preprocess_step_matches_device_layout(both_read, random_train):
    """``--host_preprocess`` (the pyramid and jitter built on the host) and
    the default device layout give the same step on the same item, also in
    ``--random_train``'s phase of independent frames: both losses within
    1e-5 relative."""
    from endodav_tpu_torch.train.trainer import Trainer

    extra = ["--random_train", "--tune_depth_interval", "1"] if random_train else []
    losses = []
    for host in ([], ["--host_preprocess"]):
        t = Trainer(port_opt("--data_path", both_read, *TRAIN_ARGS, *extra, *host))
        assert t.train_dataset.device_preprocess == (not host)
        t.train_dataset.random_train = random_train
        batch = {k: v[None] for k, v in t.train_dataset[3].items()}
        with torch.backends.mkldnn.flags(enabled=False):
            out = t.train_one_batch(batch)
        losses.append([float(out["loss"]), float(out["loss_0"])])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
