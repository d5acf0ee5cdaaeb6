"""Fp2 arithmetic in PyTorch: the quadratic extension over a
gnark_tpu_torch.ff.FF. Counterpart of gnark_tpu.ec.fp2.FF2.

Elements are shaped (..., 2, L) int64 limbs (c0 + c1*u, u^2 = nr), or
(..., 2, L/2) int32 words on the card; the kernels read a G2 coordinate
as the flat (..., 2*L/2) row c0 | c1. Plain versions only: the G2 work
on the card runs inside kernels K3 and K4 (csrc/mont.cuh's Fp2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnark_tpu_torch.ff import FF, get_ff


class FF2:
    """Fp2 = Fp[u]/(u^2 - nr) with nr a small negative integer."""

    def __init__(self, base: FF, nr: int):
        self.base = base
        self.p = base.p
        self.n = base.n
        self.nw = base.nw
        p = base.p.modulus
        nr_int = nr % p
        nr_signed = nr_int - p if nr_int > p // 2 else nr_int
        self._nr_small = nr_signed if -16 < nr_signed < 16 else None
        if self._nr_small is None:
            self._nr_mont_np = base.encode(nr_int)

    def _c(self, a, i):
        return a[..., i, :]

    def _pack(self, c0, c1):
        return torch.stack([c0, c1], dim=-2)

    def _mul_nr(self, x):
        k = self._nr_small
        if k is not None:
            if k >= 0:
                return self.base.mul_small(x, k)
            return self.base.neg(self.base.mul_small(x, -k))
        return self.base.mul(
            x, torch.as_tensor(self._nr_mont_np, device=x.device))

    # -- host <-> tensor ---------------------------------------------------

    def encode(self, values, mont: bool = True) -> np.ndarray:
        """Nested (c0, c1) int pairs -> (..., 2, L) int64 limbs."""
        arr = np.asarray(values, dtype=object)
        assert arr.shape[-1] == 2
        return self.base.encode(arr.tolist(), mont)

    def encode_words(self, values, mont: bool = True) -> np.ndarray:
        arr = np.asarray(values, dtype=object)
        assert arr.shape[-1] == 2
        return self.base.encode_words(arr.tolist(), mont)

    def decode(self, limbs, mont: bool = True):
        return self.base.decode(limbs, mont)

    def decode_words(self, words, mont: bool = True):
        return self.base.decode_words(words, mont)

    def to_words(self, limbs):
        return self.base.to_words(limbs)

    def from_words(self, words):
        return self.base.from_words(words)

    def zeros(self, shape=(), device="cpu"):
        return self.base.zeros(tuple(shape) + (2,), device)

    def ones(self, shape=(), device="cpu"):
        one = self.base.ones(tuple(shape), device)
        return self._pack(one, torch.zeros_like(one))

    # -- ring ops ----------------------------------------------------------

    # componentwise ops are the base ops over the (2, L) trailing dims
    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def double(self, a):
        return self.base.add(a, a)

    def canon(self, a):
        return self.base.canon(a)

    def mul(self, a, b):
        # Karatsuba: the 3 base products in one batched call
        a0, a1 = self._c(a, 0), self._c(a, 1)
        b0, b1 = self._c(b, 0), self._c(b, 1)
        shape = torch.broadcast_shapes(a0.shape, b0.shape)
        a0, a1, b0, b1 = (t.expand(shape) for t in (a0, a1, b0, b1))
        sa, sb = self.base.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t0, t1, t2 = self.base.mul(torch.stack([a0, a1, sa]),
                                   torch.stack([b0, b1, sb])).unbind(0)
        if self._nr_small == -1:
            c0 = self.base.sub(t0, t1)
        else:
            c0 = self.base.add(t0, self._mul_nr(t1))
        c1 = self.base.sub(self.base.sub(t2, t0), t1)
        return self._pack(c0, c1)

    def square(self, a):
        a0, a1 = self._c(a, 0), self._c(a, 1)
        t = self.base.mul(a0, a1)
        s = self.base.mul(self.base.add(a0, a1),
                          self.base.add(a0, self._mul_nr(a1)))
        c0 = self.base.sub(self.base.sub(s, t), self._mul_nr(t))
        c1 = self.base.add(t, t)
        return self._pack(c0, c1)

    def mul_small(self, a, k: int):
        return self._pack(self.base.mul_small(self._c(a, 0), k),
                          self.base.mul_small(self._c(a, 1), k))

    def mul_base(self, a, s):
        """Multiply by a base-field element s shaped (..., L)."""
        return self._pack(self.base.mul(self._c(a, 0), s),
                          self.base.mul(self._c(a, 1), s))

    # -- predicates / select / inversion -----------------------------------

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1).all(-1)

    def select(self, cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    def inv(self, a):
        """(a0 - a1 u) / (a0^2 - nr a1^2); inv(0) = 0."""
        a0, a1 = self._c(a, 0), self._c(a, 1)
        d = self.base.sub(self.base.mul(a0, a0),
                          self._mul_nr(self.base.mul(a1, a1)))
        di = self.base.inv(d)
        return self._pack(self.base.mul(a0, di),
                          self.base.neg(self.base.mul(a1, di)))


@functools.lru_cache(maxsize=None)
def get_ff2(base_name: str, nr: int) -> FF2:
    return FF2(get_ff(base_name), nr)
