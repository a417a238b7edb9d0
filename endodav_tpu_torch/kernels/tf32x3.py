"""Weight planes of the 3xTF32 tensor-core kernels, and the layouts the
kernels read their weights in.

An f32 product runs on the tensor cores as three TF32 products
(`csrc/tc_tile.cuh`): a = a_hi + a_lo with a_hi = tf32(a) and a_lo =
tf32(a - a_hi), where tf32 is ``cvt.rna.tf32.f32`` (round to nearest,
ties away from zero, to 10 mantissa bits), and a·b ~ a_lo·b_hi + a_hi·b_lo
+ a_hi·b_hi.  The kernels split their activations as they build the
fragments; the weights arrive split, as hi and lo planes that
`split_tf32` makes once per weight and `PlaneCache` keeps.

The planes are laid out the way the kernels read B: K-major, [C_out,
C_in], which is torch's own ``nn.Linear.weight``.  The wrappers take
weights in the JAX layout [C_in, C_out], as the JAX package's kernels do;
the models hand them ``lin.weight.t()``, the transposed view of the
parameter, so the K-major layout is that parameter itself.  A weight is
taken if it is contiguous or the transpose of a contiguous tensor
(`check_layout`); anything else raises.

`tf32x3_matmul` is a plain emulation of the kernels' product for the
tests; nothing on the main path calls it.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import torch

__all__ = ["split_tf32", "tf32x3_matmul", "check_layout", "PlaneCache", "kmajor_planes"]


def _rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add 0x1000 to the bit pattern, clear the low 13 bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor: hi = tf32(w), lo = tf32(w - hi), both f32
    with the low 13 bits clear; w - hi - lo is below 2^-22 of |w|."""
    if w.dtype != torch.float32:
        raise TypeError(f"split_tf32: dtype {w.dtype}, expected float32")
    hi = _rna_tf32(w)
    return hi, _rna_tf32(w - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain emulation of the kernels' 3xTF32 product a [..., M, K] @ b [..., K, N]:
    the two small cross terms first, then hi·hi, each product of TF32
    values summed in f32."""
    (ahi, alo), (bhi, blo) = split_tf32(a), split_tf32(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def check_layout(w: torch.Tensor, what: str) -> None:
    """Raise unless the 2-D weight w is contiguous or the transpose of a
    contiguous tensor (the two layouts the wrappers read)."""
    if w.dim() != 2 or not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError(f"{what}: the weight must be contiguous or the transpose of a "
                         f"contiguous tensor (shape {tuple(w.shape)}, strides {w.stride()})")


class PlaneCache:
    """Planes made from weights, kept until the weight changes.

    Keyed by the weight's data_ptr, shape, strides, version counter
    (`_version`, shared by a parameter and its views and bumped by every
    in-place update), dtype and device; an entry also holds a weak
    reference to the tensor that owns the weight's storage and is dropped
    when that tensor dies, so a later tensor at the same address never
    hits it.  At most `limit` entries, the least recently used dropped
    first.
    """

    def __init__(self, limit: int = 256):
        self.limit = limit
        self.hits = 0
        self.misses = 0
        self._entries: OrderedDict = OrderedDict()

    @staticmethod
    def key(w: torch.Tensor) -> tuple:
        return (w.data_ptr(), tuple(w.shape), w.stride(), w._version, w.dtype, w.device)

    def get(self, w: torch.Tensor, make):
        """The planes of w: cached, or ``make()`` on a miss."""
        key = self.key(w)
        owner = w if w._base is None else w._base
        entry = self._entries.get(key)
        if entry is not None and entry[0]() is owner:
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[1]
        self.misses += 1
        planes = make()
        self._entries[key] = (weakref.ref(owner, lambda _, k=key: self._entries.pop(k, None)),
                              planes)
        while len(self._entries) > self.limit:
            self._entries.popitem(last=False)
        return planes

    def __len__(self) -> int:
        return len(self._entries)


def kmajor_planes(cache: PlaneCache, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B operand of a tensor-core kernel from a JAX-layout weight w [K, N]:
    K-major [N, K] planes (hi, lo) for f32, made once per weight version;
    for bf16 the K-major weight twice (no lo plane), which is w.t() itself
    when w is the transposed view of a torch-layout parameter."""
    check_layout(w, "weight")
    if w.dtype == torch.bfloat16 and w.t().is_contiguous():
        return w.t(), w.t()
    if w.dtype == torch.bfloat16:
        k = cache.get(w, lambda: w.t().contiguous())
        return k, k
    return cache.get(w, lambda: split_tf32(w.t().contiguous()))
