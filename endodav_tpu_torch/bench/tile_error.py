"""The 3xTF32 tensor-core tile's own product on the card, to measure its
f32 error against K (`tile_error.cu`).

`tile_matmul(a, b)` computes a [M, K] @ b [K, N] through `warp_tile` of
`csrc/tc_tile.cuh` in the kernels' accumulation order.  The source is
built with nvcc into its own small library under `endodav_tpu_torch/_build/`
on first use (seconds: a plain C interface); it is not part of the kernels'
library.  Used by `chip_smoke.py`'s tile phase and the card's tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from endodav_tpu_torch.kernels import _build
from endodav_tpu_torch.kernels.tf32x3 import split_tf32, tf32x3_matmul

__all__ = ["tile_matmul", "library"]

_SOURCE = Path(__file__).resolve().parent / "tile_error.cu"
_HEADERS = ("common.cuh", "tc_tile.cuh")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The tile's library, built on first call; raises with nvcc's output."""
    global _lib
    with _lock:
        if _lib is None:
            files = [_SOURCE, *(_build._CSRC / h for h in _HEADERS)]
            digest = hashlib.sha256(b"".join(p.read_bytes() for p in files)
                                    + " ".join(_build._FLAGS).encode()).hexdigest()[:16]
            so = _build._BUILD / f"libendodav_tile_error_{digest}.so"
            if not so.exists():
                _build._BUILD.mkdir(exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                res = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-I",
                                      str(_build._CSRC), "-o", str(tmp), str(_SOURCE)],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {_SOURCE.name} with exit code "
                                       f"{res.returncode}:\n{res.stdout}{res.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.endodav_tile_error.argtypes = [vp, vp, vp, vp, i, i, i, vp]
            lib.endodav_tile_error.restype = i
            _lib = lib
    return _lib


def tile_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] in f32 through the 3xTF32 tile; M and N multiples
    of 16, K of 32.  On a CPU tensor: `tf32x3_matmul`, which rounds every
    sum to nearest."""
    if a.device.type == "cpu":
        return tf32x3_matmul(a, b)
    (m, k), n = a.shape, b.shape[1]
    if a.dtype != torch.float32 or b.dtype != torch.float32 or b.shape[0] != k:
        raise ValueError(f"tile_matmul: f32 [M, K] @ [K, N], got {tuple(a.shape)} {a.dtype} "
                         f"and {tuple(b.shape)} {b.dtype}")
    if m % 16 or n % 16 or k % 32:
        raise ValueError(f"tile_matmul: M={m} and N={n} must be multiples of 16, K={k} of 32")
    lib = library()
    a = a.contiguous()
    hi, lo = split_tf32(b.t().contiguous())
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.endodav_tile_error(a.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(),
                                     m, n, k, _build.stream_of(a))
    _build.check(err, "tile_matmul")
    return out
