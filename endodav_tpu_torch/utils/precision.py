"""The f32 precision policy of the port's entry points.

PyTorch runs f32 matrix products on the card in IEEE f32 by default, but
f32 convolutions through cuDNN in TF32 (``torch.backends.cudnn.allow_tf32``
is True), which keeps about three decimal digits: about 1e-3 relative
error in every patch embed, DPT convolution, head and ResNet layer.  The
port's results are stated in f32 (the card against the CPU to 2e-4, the
JAX package's f32 contract), so every entry point that builds a model
(`eval.engine.build_depth_model`, `eval.streaming.DepthStreamer`,
`train.trainer.Trainer`) calls `set_f32_policy` first: IEEE f32 for
both, TF32 off.

TF32 is an explicit opt-in, ``ENDODAV_TF32=1``, and is not measured: no
time or error in the port's records was taken with it.
The switches are PyTorch's own and hold for the whole process, as they
do for any caller that sets them.
"""

from __future__ import annotations

import torch

from endodav_tpu_torch.utils.envflags import env_on

__all__ = ["set_f32_policy"]


def set_f32_policy() -> bool:
    """Set PyTorch's f32 policy for products and convolutions on the card:
    IEEE f32 (TF32 off) unless the ``ENDODAV_TF32`` flag asks for TF32.
    Prints the policy on one line and returns whether TF32 is on."""
    tf32 = env_on("ENDODAV_TF32")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    print("[precision] f32 products and convolutions: "
          + ("TF32 (opt-in, unmeasured)" if tf32
             else "IEEE f32, TF32 off (ENDODAV_TF32=1 opts in)"))
    return tf32
