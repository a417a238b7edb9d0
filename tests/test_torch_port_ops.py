"""Port parity: ops/resize.py against the JAX package, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from endodav_tpu.ops import resize as jresize
from endodav_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)
RNG = np.random.default_rng(11)


@pytest.mark.parametrize("in_size,out_size,method,ac,scale", [
    (37, 16, "bicubic", False, (16 + 0.1) / 37),
    (512, 518, "bicubic", False, None),
    (16, 64, "bilinear", True, None),
    (518, 512, "bilinear", True, None),
    (40, 20, "bilinear", False, None),
])
def test_interp_matrix_matches_jax(in_size, out_size, method, ac, scale):
    want = jresize.interp_matrix(in_size, out_size, method, ac, False, scale)
    got = tresize.interp_matrix(in_size, out_size, method, ac, scale)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    # the model preprocess / DPT / output upsample
    dict(shape=(2, 3, 20, 24, 5), size=(28, 42), method="bilinear", align_corners=True),
    # the single-channel disparity upsample to source resolution
    dict(shape=(4, 9, 11, 1), size=(32, 40), method="bilinear", align_corners=True),
    # the keep-aspect frame resize (cv2 INTER_CUBIC semantics)
    dict(shape=(3, 32, 40, 3), size=(42, 56), method="bicubic", align_corners=False),
    # the ViT pos-embed interpolation with explicit scale factors
    dict(shape=(1, 37, 37, 8), size=(4, 5), method="bicubic", align_corners=False,
         scale_hw=((4 + 0.1) / 37, (5 + 0.1) / 37)),
])
def test_resize2d_matches_jax(case):
    case = dict(case)
    x = RNG.standard_normal(case.pop("shape")).astype(np.float32)
    size = case.pop("size")
    want = np.asarray(jresize.resize2d(jnp.asarray(x), size, **case))
    got = tresize.resize2d(torch.from_numpy(x), size, **case).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_resize2d_identity_and_bf16():
    x = torch.from_numpy(RNG.standard_normal((2, 6, 7, 3)).astype(np.float32))
    assert tresize.resize2d(x, (6, 7)) is x
    xb = x.bfloat16()
    out = tresize.resize2d(xb, (12, 14), "bilinear", align_corners=True)
    assert out.dtype == torch.bfloat16
    ref = tresize.resize2d(xb.float(), (12, 14), "bilinear", align_corners=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)
