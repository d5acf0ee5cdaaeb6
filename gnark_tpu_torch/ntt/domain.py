"""Radix-2 NTT domains over 2-adic prime fields, on word tensors.

Counterpart of gnark_tpu.ntt.domain.Domain (gnark-crypto fft.Domain):
FFT and FFTInverse, optionally on the coset g*<omega>, over (n, nw)
int32 word vectors in Montgomery form. The plan follows the reference's
size switch: below 2^GNARK_TPU_NTT_FOURSTEP_LOG (default 14, read at each
transform) and at n = 2 the radix-2 plan (ntt/radix2.py: kernel K5), at
and above it the four-step plan (ntt/fourstep.py: kernels K2 and K1).
The coset and n^-1 scalings are K1 products.
"""

from __future__ import annotations

import os

import torch

from gnark_tpu_torch.cuda import resolve_device
from gnark_tpu_torch.ff import FF
from gnark_tpu_torch.ff.mont_mul import mont_mul
from gnark_tpu_torch.ntt.fourstep import FourStep, _powers
from gnark_tpu_torch.ntt.radix2 import Radix2


def fourstep_threshold() -> int:
    """Smallest n that takes the four-step plan (never below 4)."""
    return max(1 << int(os.environ.get("GNARK_TPU_NTT_FOURSTEP_LOG", "14")),
               4)


class Domain:
    """Evaluation domain of size n = 2^k with coset support.

    `omega` is a primitive n-th root of unity; the coset is g*<omega>
    with g the field's multiplicative generator (g^n != 1)."""

    def __init__(self, ff: FF, n: int, device=None):
        if n & (n - 1) or n == 0:
            raise ValueError("domain size must be a power of two")
        self.ff = ff
        self.n = n
        self.device = resolve_device(device)
        p = ff.p.modulus
        self.omega = ff.p.root_of_unity(n) if n > 1 else 1
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(n, -1, p)
        self.coset_gen = ff.p.generator % p
        self.coset_gen_inv = pow(self.coset_gen, -1, p)
        self._plans: dict = {}
        gi = _powers(self.coset_gen_inv, n, p)
        self._coset = self._dev(_powers(self.coset_gen, n, p))
        self._coset_inv_ninv = self._dev([v * self.n_inv % p for v in gi])
        self._ninv = self._dev([self.n_inv])
        if n > 1:                        # build both plans up front
            self._plan(False)
            self._plan(True)

    def _dev(self, vals):
        return torch.as_tensor(self.ff.encode_words(vals), device=self.device)

    def _plan(self, inverse: bool):
        """The plan for this size under the current threshold, built on
        first use and kept."""
        four = self.n >= fourstep_threshold()
        key = (four, inverse)
        if key not in self._plans:
            w = self.omega_inv if inverse else self.omega
            plan = FourStep if four else Radix2
            self._plans[key] = plan(self.ff, self.n, w, self.device)
        return self._plans[key]

    def fft(self, x: torch.Tensor, coset: bool = False) -> torch.Tensor:
        """Coefficients -> evaluations on (a coset of) the domain."""
        if self.n == 1:
            return x
        if coset:
            x = mont_mul(self.ff, x, self._coset)
        return self._plan(False)(x)

    def ifft(self, y: torch.Tensor, coset: bool = False) -> torch.Tensor:
        """Evaluations on (a coset of) the domain -> coefficients."""
        if self.n == 1:
            return y
        x = self._plan(True)(y)
        return mont_mul(self.ff, x,
                        self._coset_inv_ninv if coset else self._ninv)
