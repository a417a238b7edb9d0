"""The port imports without JAX: neither `import endodav_tpu_torch` nor any
of its submodules may pull in jax, flax, msgpack or the JAX package, and no
import statement of the port or of `chip_smoke.py`, at module level or
inside a function, names one of them."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import endodav_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "endodav_tpu")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(endodav_tpu_torch.__path__,
                                                        "endodav_tpu_torch."))


def test_port_imports_leave_jax_out():
    mods = _submodules()
    assert "endodav_tpu_torch.eval.engine" in mods and "endodav_tpu_torch.kernels._build" in mods
    for new in ("eval.streaming", "kernels.fused_rcu", "kernels.temporal_attention",
                "utils.msgpack", "utils.checkpoint", "eval.metrics_device",
                "cli.train_end_to_end_video", "cli.evaluate_depth_video_pose"):
        assert f"endodav_tpu_torch.{new}" in mods, new
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path):
    """Top-level package of every import statement in the file."""
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_import_statement_names_jax_flax_or_msgpack():
    """Imports inside functions too (a kernel or a reader imports lazily)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "endodav_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    bad = {os.path.relpath(f, REPO): sorted(set(_imported_names(f)) & set(FORBIDDEN))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


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
