"""Build and load the port's CUDA kernels.

The sources under `endodav_tpu_torch/csrc/` have a plain C interface, so
nvcc compiles them without PyTorch's headers (seconds, not minutes): one
nvcc per source, all started together, then one link into a shared
library under `endodav_tpu_torch/_build/`, named by a hash of the
sources and flags.  The library is built at first use and loaded with
`ctypes`; nothing here runs at import time, and a failed build raises
with nvcc's output.  A file lock serialises the build across processes.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["library", "compile_library", "build_log", "check", "dtype_code", "stream_of"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = ("flash_attention.cu", "fused_temporal_block.cu", "fused_mlp.cu", "warp.cu",
            "fused_rcu.cu", "temporal_attention.cu")
_HEADERS = ("common.cuh", "tc_tile.cuh", "tma.cuh", "warp_attention.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_log = ""

_vp, _int, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "endodav_cuda_error_string": ([_int], ctypes.c_char_p),
    "endodav_flash_attention": ([_int, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                                 _ll, _ll, _f, _vp], _int),
    "endodav_fused_temporal_block": ([_int, *[_vp] * 15, _int, _int, _int, _int, _int, _int,
                                      _f, _vp], _int),
    "endodav_fused_mlp": ([_int, *[_vp] * 8, _int, _int, _int, _int, _vp], _int),
    "endodav_grid_sample_fwd": ([_vp, _vp, _vp, _vp, *[_int] * 9, _vp], _int),
    "endodav_grid_sample_bwd": ([*[_vp] * 8, *[_int] * 9, _vp], _int),
    "endodav_splat": ([_vp, _vp, _vp, _int, _int, _int, _int, _vp], _int),
    "endodav_fused_rcu": ([_int, *[_vp] * 8, _int, _int, _int, _int, _vp], _int),
    "endodav_temporal_attention": ([_int, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                                    _f, _vp], _int),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
                           "toolkit is needed to build the kernels")
    return path


def _compile() -> Path:
    global _log
    files = [_CSRC / n for n in _SOURCES + _HEADERS]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in files) + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"libendodav_kernels_{digest}.so"
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [_BUILD / f"{Path(n).stem}.{tag}.o" for n in _SOURCES]
    procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", str(o), str(_CSRC / n)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, o in zip(_SOURCES, objs)]
    outs = [(n, p.communicate()[0], p.returncode) for n, p in zip(_SOURCES, procs)]
    _log = "".join(f"== {n}\n{out}" for n, out, _ in outs)
    failed = [(n, rc) for n, _, rc in outs if rc != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{_log}")
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    _log += res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed with exit code {res.returncode}:\n{_log}")
    for o in objs:
        o.unlink()
    os.replace(tmp, so)
    return so


def compile_library() -> Path:
    """Build the shared library if no process has built it yet, and return
    its path.  A file lock under `_build/` makes processes that start
    together (the ranks of `parallel.launch`) wait for one build."""
    _BUILD.mkdir(exist_ok=True)
    with open(_BUILD / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _compile()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def build_log() -> str:
    """nvcc's output (with ptxas's register and shared-memory report) of the
    build this process ran; empty when the library was already built."""
    return _log


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().endodav_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on the tensor's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
