"""K1 mont_mul: elementwise Montgomery product over word tensors.

Counterpart of gnark_tpu.ff.pallas_ops.mul_p and of
gnark_tpu.ntt.fourstep._mid_mul: out[i] = a[i] * b[i] * R^-1, or
a[i] * b[0] * R^-1 when b holds one element, canonical. Kernel:
csrc/mont_mul.cu. On a CPU tensor the plain version runs; on a CUDA
tensor the kernel, or an error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff.mont import FF


def mont_mul_plain(ff: FF, a: torch.Tensor, b: torch.Tensor):
    """Plain version over int64 limbs: (n, nw) words x (n or 1, nw)
    words -> canonical (n, nw) words."""
    return ff.to_words(ff.mul(ff.from_words(a), ff.from_words(b)))


@functools.lru_cache(maxsize=None)
def _fn():
    return cuda.bind("mont_mul", "gt_mont_mul", 3,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def mont_mul(ff: FF, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (..., nw) int32 words, b: the same shape or one element
    ((nw,) or (1, nw)); inputs < 2p. Returns canonical words shaped
    like a."""
    shape = a.shape
    a2 = a.reshape(-1, ff.nw)
    b2 = b.reshape(-1, ff.nw)
    n = a2.shape[0]
    if b2.shape[0] not in (1, n):
        raise ValueError(f"mont_mul: b has {b2.shape[0]} elements, "
                         f"a has {n}")
    if b2.device != a2.device:
        raise ValueError("mont_mul: operands on different devices")
    if a2.device.type == "cpu":
        return mont_mul_plain(ff, a2, b2).reshape(shape)
    consts = cuda.field_consts(ff.p.name)
    a2 = cuda.dev_words(a2, "mont_mul a")
    b2 = cuda.dev_words(b2, "mont_mul b")
    out = torch.empty_like(a2)
    rc = _fn()(a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n,
               int(b2.shape[0] == 1 and n != 1), consts.ctypes.data,
               cuda.stream(a2))
    cuda.check(rc, "mont_mul")
    mont_mul.launches += 1
    return out.reshape(shape)


mont_mul.launches = 0
