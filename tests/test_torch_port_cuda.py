"""The port's CUDA kernels against their plain versions on a CUDA card.

Marked `cuda`; each test skips without a card (the kernels have no CPU
mode).  The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from endodav_tpu_torch.kernels.flash_attention import attention_reference, qkv_attention
from endodav_tpu_torch.kernels.fused_temporal_block import fused_temporal_block, reference_block

torch.set_num_threads(1)

# f32: summation order; bf16: 8-bit-mantissa inputs and intermediates,
# compared with the plain version in f32 on the same (rounded) inputs
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads", [(2, 97, 2), (1, 1, 6), (3, 321, 6)])
def test_flash_attention_matches_plain(dtype, b, n, heads):
    dev = _card()
    c = heads * 64
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32)).to(dev)
    qkv = qkv.to(dtype)
    want = attention_reference(*(qkv.float()[..., i * c:(i + 1) * c].reshape(b, n, heads, 64)
                                 for i in range(3)), 0.125).reshape(b, n, c)
    before = qkv_attention.launches
    got = qkv_attention(qkv, heads)
    torch.cuda.synchronize()
    assert qkv_attention.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,t,c", [(9, 32, 64), (13, 8, 64), (5, 5, 192), (3, 32, 384)])
def test_fused_temporal_block_matches_plain(dtype, rows, t, c):
    dev = _card()
    rng = np.random.default_rng(rows * c + t)
    f = lambda *s, sd=0.2: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sd).astype(np.float32)).to(dev)
    x = f(rows, t, c, sd=0.5)
    gamma, beta, pe = 1.0 + f(c), f(c), f(t, c)
    ws = [f(c, c, sd=c ** -0.5) for _ in range(4)]
    bo = f(c)
    args = [a.to(dtype) for a in (x, *ws, bo)]
    want = reference_block(args[0].float(), gamma, beta, pe, *(a.float() for a in args[1:5]),
                           args[5].float(), 8)
    before = fused_temporal_block.launches
    got = fused_temporal_block(args[0], gamma, beta, pe, *args[1:5], args[5], 8)
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 1 and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]
