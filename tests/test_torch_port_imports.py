"""The port imports without JAX: neither `import endodav_tpu_torch` nor any
of its submodules may pull in jax, flax or the JAX package."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import endodav_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(endodav_tpu_torch.__path__,
                                                        "endodav_tpu_torch."))


def test_port_imports_leave_jax_out():
    mods = _submodules()
    assert "endodav_tpu_torch.eval.engine" in mods and "endodav_tpu_torch.kernels._build" in mods
    for new in ("eval.streaming", "kernels.fused_rcu", "kernels.temporal_attention"):
        assert f"endodav_tpu_torch.{new}" in mods, new
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'endodav_tpu'))\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    """`chip_smoke.py` exits non-zero and prints no result line when
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_cli_flags_match_the_jax_cli():
    """Every flag of the port's eval CLI exists in the JAX CLI with the same
    default, apart from the port's own --seed."""
    from endodav_tpu_torch.options import EndoDAVOptions

    src = open(os.path.join(REPO, "endodav_tpu", "options.py")).read()
    port = EndoDAVOptions().parse([])
    for name, value in vars(port).items():
        if name == "seed":
            continue
        assert f'"--{name}"' in src, name
    assert port.depth_image_shape == [224, 280] and port.lora_type == "dvlora"
    assert port.chunk_windows == 2 and port.residual_block_indexes == [2, 5, 8, 11]
