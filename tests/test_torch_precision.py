"""The port's f32 precision policy: every entry point that builds a model
(`build_depth_model`, `DepthStreamer`, `Trainer`) leaves PyTorch's TF32
switches off, starting from PyTorch's own defaults (cuDNN convolutions in
TF32), and ``ENDODAV_TF32=1`` turns them on.  The switches are process-wide, so each test restores them."""

import pytest
import torch

from endodav_tpu_torch.utils.precision import set_f32_policy

torch.set_num_threads(1)

# a small configuration of each entry point, on the CPU
EVAL_FLAGS = ["--no_cuda", "--depth_image_shape", "28", "42"]
TRAIN_FLAGS = ["--no_cuda", "--data_path", "/nonexistent", "--height", "64", "--width", "96",
               "--T", "4", "--depth_image_shape", "28", "42", "--num_workers", "1"]


@pytest.fixture
def pytorch_defaults():
    """PyTorch's defaults for the switches (cuDNN TF32 on, matmul TF32
    off) during the test; the values found before it afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _build_depth_model():
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.options import EndoDAVOptions

    engine.build_depth_model(EndoDAVOptions().parse(EVAL_FLAGS))


def _depth_streamer():
    from endodav_tpu_torch.eval.streaming import DepthStreamer

    DepthStreamer(lambda win: win, (28, 42), device="cpu")


def _trainer():
    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.train.trainer import Trainer

    Trainer(EndoDAVOptions().parse(TRAIN_FLAGS))


ENTRY_POINTS = {"build_depth_model": _build_depth_model, "DepthStreamer": _depth_streamer,
                "Trainer": _trainer}


@pytest.mark.parametrize("opt_in", [False, True], ids=["default", "ENDODAV_TF32=1"])
@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_set_the_f32_policy(pytorch_defaults, monkeypatch, capsys, entry, opt_in):
    if opt_in:
        monkeypatch.setenv("ENDODAV_TF32", "1")
    else:
        monkeypatch.delenv("ENDODAV_TF32", raising=False)
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default, before the entry point
    ENTRY_POINTS[entry]()
    assert torch.backends.cudnn.allow_tf32 is opt_in
    assert torch.backends.cuda.matmul.allow_tf32 is opt_in
    said = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[precision]")]
    assert said and ("TF32 (opt-in" in said[-1]) is opt_in


@pytest.mark.parametrize("env", ["0", "", "off"])
def test_falsy_flags_keep_tf32_off(pytorch_defaults, monkeypatch, env):
    monkeypatch.setenv("ENDODAV_TF32", env)
    assert set_f32_policy() is False
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setenv("ENDODAV_TF32", "1")
    assert set_f32_policy() is True
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
