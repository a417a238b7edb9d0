"""The port's data parallelism (`endodav_tpu_torch/parallel/__init__.py`)
on gloo ranks on the CPU.

* the window path of `infer_video_depth` at data=2 against data=1;
* one `Trainer` step at ``--mesh_shape data=2`` against the data=1 step on
  the same global batch and weights (`tests/test_torch_train_step.py`
  holds the data=1 step against JAX's, and JAX's own test its data=N step
  against data=1): every loss within 1e-4 (JAX's bound,
  `tests/test_train_step.py:319-331`), each phase's gradients within 1e-4
  of that phase's largest entry, the BatchNorm running statistics within
  1e-5 and the updated weights within 1e-4, and both ranks' weights and
  statistics identical;
* the loader's shards, the mesh flags' rules and the rejections
  (``chunk_windows % N``, ``B % N``, a training ``model=N``), the backend
  choice and the CLIs' rank counts.

The window path and the data=2 step run in one world of two gloo ranks
(`dp_runs`) with its own time limit; the ranks import no JAX.
"""

import argparse

import numpy as np
import pytest
import torch

from endodav_tpu_torch import parallel
from endodav_tpu_torch.models.endodav import EndoDAV

import torch_parallel_workers as W

torch.set_num_threads(1)

LAUNCH_S = 240  # the world's time limit
B, T, H, WD = 2, 2, 32, 64
SCALES = (0, 1, 2, 3)
FLAGS = ["--no_cuda", "--data_path", "/nonexistent", "--height", str(H), "--width", str(WD),
         "--batch_size", str(B), "--T", str(T), "--depth_image_shape", "28", "42",
         "--residual_block_indexes", "1", "--warm_up_step", "5", "--depth_reproj", "0.01",
         "--depth_flow", "0.01", "--num_workers", "1"]


def _batch(seed=314):
    """A loader-shaped global batch [B, T, ...] (`tests/test_train_step.py`)."""
    from endodav_tpu_torch.data.pipeline import scaled_intrinsics

    rng = np.random.default_rng(seed)
    batch = {}
    for fi in (0, -1, 1):
        for s in SCALES:
            arr = rng.uniform(0.1, 0.9, (B, T, H // 2 ** s, WD // 2 ** s, 3)).astype(np.float32)
            batch[("color", fi, s)] = arr
            batch[("color_aug", fi, s)] = arr + rng.normal(0, 0.01, arr.shape).astype(np.float32)
    for s in SCALES:
        K, iK = scaled_intrinsics(WD, H, s)
        batch[("K", s)] = np.broadcast_to(K, (B, T, 4, 4)).copy()
        batch[("inv_K", s)] = np.broadcast_to(iK, (B, T, 4, 4)).copy()
    return batch


def _window_setup():
    """A 32-frame EndoDAV at 28x42 (seeded weights), 60 frames of 40x48 and
    the single process's window path over them."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth

    cfg = dict(encoder="vits", image_shape=(28, 42), lora_type="none", residual_block_indexes=())
    model = engine.init_random_(EndoDAV(**cfg), 3).eval()
    frames = np.random.default_rng(8).integers(0, 255, (60, 40, 48, 3), dtype=np.uint8)
    want = infer_video_depth(engine.depth_window_forward(model), frames, image_shape=(28, 42),
                             chunk_windows=2, device="cpu")
    return model, frames, want


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The data=1 step in this process, then one world of two ranks that
    runs the window path at data=2 and the data=2 step, from the trainer's
    seeded init with visible flows and camera motion
    (`torch_parallel_workers.with_motion`); the ranks report their largest
    differences from the data=1 step and whether they match rank 0."""
    tmp = tmp_path_factory.mktemp("dp")
    model, frames, want = _window_setup()
    win = str(tmp / "win.pt")
    torch.save({"cls": EndoDAV, "config": model.config, "state": model.state_dict(),
                "frames": frames, "shape": (28, 42)}, win)
    step = str(tmp / "step.pt")
    torch.save({"flags": FLAGS, "batch": _batch()}, step)
    W.train_step(step, 1)
    jobs = [("window_dp", (win, win + ".out", 2), {}), ("train_step", (step, 2), {})]
    parallel.launch(W.run_jobs, (jobs,), n=2, devices=["cpu", "cpu"], timeout=LAUNCH_S)
    return {"window": (frames, want, torch.load(win + ".out", weights_only=False)),
            "steps": (torch.load(f"{step}.d1", weights_only=False),
                      torch.load(f"{step}.d2", weights_only=False))}


def test_window_path_data2_matches_data1(dp_runs):
    """Two ranks each run half of every chunk's windows and gather the
    chunk: the stitched video is the single process's."""
    frames, want, got = dp_runs["window"]
    assert got.shape == want.shape == frames.shape[:3]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def steps(dp_runs):
    """The data=1 and data=2 steps' reports (`dp_runs`)."""
    return dp_runs["steps"]


def test_train_step_losses_match_data1(steps):
    one, two = steps
    assert set(one["scalars"]) == set(two["scalars"])
    for k, v in one["scalars"].items():
        assert abs(two["scalars"][k] - v) <= 1e-4 * max(1.0, abs(v)), k


def test_train_step_gradients_match_data1(steps):
    """Each phase's summed gradients (phase 0: the position nets; main: the
    six main components) within 1e-4 of the phase's largest entry."""
    from endodav_tpu_torch.train.trainer import POSITION_COMPONENTS

    one, two = steps
    assert two["grad_keys"] == sorted(one["grads"])
    for phase0 in (True, False):
        keys = [k for k in one["grads"] if (k.split(".")[0] in POSITION_COMPONENTS) == phase0]
        scale = max(one["grads"][k].abs().max().item() for k in keys)
        for k in keys:
            assert two["grads"][k] <= 1e-4 * scale, (k, two["grads"][k], scale)


def test_train_step_weights_and_statistics(steps):
    """The updated weights within 1e-4, the BatchNorm running statistics of
    the global batch within 1e-5, and the two ranks bit for bit alike."""
    one, two = steps
    assert two["ranks_unlike"] == 0, two["unlike_rank0"]
    assert set(two["state"]) == set(one["state"])
    for k, diff in two["state"].items():
        assert diff <= (1e-5 if "running" in k else 1e-4), (k, diff)
    stats = [k for k in one["state"] if k.startswith("position_encoder") and "running_mean" in k]
    assert stats and any(one["state"][k].abs().max() > 0 for k in stats)


class _Dataset:
    epoch = 0

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"i": np.asarray(i), "x": np.full((2,), i, np.float32)}


def test_loader_shards_are_slices_of_the_global_batch():
    from endodav_tpu_torch.data.loader import Loader

    glob = [b["i"] for b in Loader(_Dataset(), 4, shuffle=True)]
    for r in range(2):
        part = [b["i"] for b in Loader(_Dataset(), 4, shuffle=True, shard=(r, 2))]
        assert [p.tolist() for p in part] == [g[2 * r:2 * r + 2].tolist() for g in glob]
    with pytest.raises(ValueError, match="not divisible by the data axis of 2"):
        Loader(_Dataset(), 3, shard=(0, 2))


def test_mesh_flags_and_rejections(capsys):
    from endodav_tpu_torch.eval.video_inference import infer_video_depth
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    P = parallel
    assert P.parse_mesh_shape("") is None and P.parse_mesh_shape("data=4") == 4
    assert P.parse_mesh_shape("model=4", allow_model=True) is None
    with pytest.raises(ValueError, match="mesh spec must be 'data=N', got 'model=4'"):
        P.parse_mesh_shape("model=4")
    assert P.build_mesh("model=4", default_all=False, allow_model=True) is None
    assert P.build_mesh("", default_all=False) is None
    with pytest.raises(ValueError, match="mesh wants 2 devices, only 1 visible"):
        P.build_mesh("data=2", devices=["cpu"])
    mesh = P.build_mesh("data=2", devices=["cpu"], clamp=True)
    assert mesh.size == 1 and "clamped to data=1" in capsys.readouterr().out
    with pytest.raises(ValueError, match="mesh spec must be 'data=N'"):
        Trainer(EndoDAVOptions().parse([*FLAGS, "--mesh_shape", "model=2"]))

    two = argparse.Namespace(axis_size=lambda axis: 2, axis_rank=lambda axis: 0)
    with pytest.raises(ValueError, match="batch of 3 is not divisible by the data axis of 2"):
        P.data_sharding(3, two)
    assert P.data_sharding(4, two) == slice(0, 2)
    frames = np.zeros((40, 32, 32, 3), np.uint8)
    with pytest.raises(AssertionError, match="multiple of the mesh 'data' axis"):
        infer_video_depth(None, frames, chunk_windows=3, device="cpu", mesh=two)

    assert P.choose_backend(["cpu", "cpu"]) == "gloo"
    assert P.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert P.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    with pytest.raises(ValueError, match="all be CUDA or all the CPU"):
        P.choose_backend(["cuda:0", "cpu"])


def test_cli_rank_counts(capsys):
    """A training ``data=N`` above the visible devices clamps (one rank
    here: the plain run is replaced by a world of one); serving raises
    JAX's errors."""
    from endodav_tpu_torch.options import EndoDAVOptions

    seen = []
    opt = EndoDAVOptions().parse(["--no_cuda", "--mesh_shape", "data=2"])
    parallel.run_cli(lambda o: seen.append(parallel.world_devices()), opt, training=True)
    assert seen == [[torch.device("cpu")]]
    out = capsys.readouterr().out
    assert "clamped to data=1" in out and "backend=gloo world=1" in out
    assert parallel.run_cli(lambda o: "plain", EndoDAVOptions().parse(["--no_cuda"]),
                            training=True) == "plain"
    for spec, msg in (("model=2", "tensor-parallel mesh wants 2 devices, only 1 visible"),
                      ("data=2", "mesh wants 2 devices, only 1 visible")):
        opt = EndoDAVOptions().parse(["--no_cuda", "--serve_mesh", spec])
        with pytest.raises(ValueError, match=msg):
            parallel.run_cli(lambda o: None, opt, training=False)
