"""K1: elementwise Montgomery arithmetic over word tensors.

mont_mul is the counterpart of gnark_tpu.ff.pallas_ops.mul_p and of
gnark_tpu.ntt.fourstep._mid_mul: out[i] = a[i] * b[i] * R^-1, or
a[i] * b[0] * R^-1 when b holds one element, canonical.
mont_mul_sub_mul fuses computeH's pointwise step, (a*b - c)*d, where the
reference runs mul_p, an XLA subtract and mul_p. Kernels:
csrc/mont_mul.cu, which also holds the affine kernel of
msm/fixed_base.affine_words. On a CPU tensor the plain version runs; on
a CUDA tensor the kernel, or an error.
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
def _fn(field):
    return cuda.bind("mont_mul", field, "gt_mont_mul", 3,
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
    rc = _fn(ff.p.name)(a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n,
               int(b2.shape[0] == 1 and n != 1), consts.ctypes.data,
               cuda.stream(a2))
    cuda.check(rc, "mont_mul")
    mont_mul.launches += 1
    return out.reshape(shape)


mont_mul.launches = 0


def mont_mul_sub_mul_plain(ff: FF, a, b, c, d):
    """Plain version of mont_mul_sub_mul over int64 limbs."""
    c = ff.canon(ff.from_words(c))
    t = ff.sub(ff.mul(ff.from_words(a), ff.from_words(b)), c)
    return ff.to_words(ff.mul(t, ff.from_words(d)))


@functools.lru_cache(maxsize=None)
def _sub_fn(field):
    return cuda.bind("mont_mul", field, "gt_mont_mul_sub_mul", 5,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def mont_mul_sub_mul(ff: FF, a, b, c, d) -> torch.Tensor:
    """(a*b - c) * d in Montgomery form: a, b, c (n, nw) int32 words, d
    the same shape or one element; inputs < 2p. Returns canonical (n, nw)
    words, in one launch on the card."""
    n = a.shape[0]
    d2 = d.reshape(-1, ff.nw)
    if any(tuple(t.shape) != (n, ff.nw) for t in (a, b, c)) or \
            d2.shape[0] not in (1, n):
        raise ValueError(f"mont_mul_sub_mul: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(d.shape)}")
    if any(t.device != a.device for t in (b, c, d2)):
        raise ValueError("mont_mul_sub_mul: operands on different devices")
    if a.device.type == "cpu":
        return mont_mul_sub_mul_plain(ff, a, b, c, d2)
    out = _sub_card(ff, a, b, c, d2)
    mont_mul_sub_mul.launches += 1
    return out


def _sub_card(ff, a, b, c, d2):
    n = a.shape[0]
    consts = cuda.field_consts(ff.p.name)
    a, b, c, d2 = (cuda.dev_words(t, "mont_mul_sub_mul")
                   for t in (a, b, c, d2))
    out = torch.empty_like(a)
    fn = _sub_fn(ff.p.name)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d2.data_ptr(),
            out.data_ptr(), n, int(d2.shape[0] == 1 and n != 1),
            consts.ctypes.data, cuda.stream(a))
    cuda.check(rc, "mont_mul_sub_mul")
    return out


mont_mul_sub_mul.launches = 0
