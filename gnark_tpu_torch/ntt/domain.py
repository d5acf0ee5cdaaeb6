"""Radix-2 NTT domains over 2-adic prime fields, on word tensors.

Counterpart of gnark_tpu.ntt.domain.Domain (gnark-crypto fft.Domain):
FFT and FFTInverse, optionally on the coset g*<omega>, over (n, nw)
int32 word vectors in Montgomery form. The plan follows the reference's
size switch: below 2^GNARK_TPU_NTT_FOURSTEP_LOG (default 14, read at each
transform) and at n = 2 the radix-2 plan (ntt/radix2.py: kernel K5), at
and above it the four-step plan (ntt/fourstep.py: kernel K2). Both plans
take the coset and n^-1 scalings as a pre- and a post-scale: the four-step
plan inside its two launches (on pass 1's load, on pass 2's store), the
radix-2 plan as K1 products.
"""

from __future__ import annotations

import os

import torch

from gnark_tpu_torch.cuda import resolve_device
from gnark_tpu_torch.ff import FF
from gnark_tpu_torch.ntt.fourstep import FourStep, power_table
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
        dev = self.device
        self._coset = power_table(ff, [self.coset_gen], n, dev)
        self._coset_inv_ninv = power_table(ff, [self.coset_gen_inv], n, dev,
                                           scale=self.n_inv)
        self._ninv = torch.as_tensor(ff.encode_words([self.n_inv]),
                                     device=dev)
        if n > 1:                        # build both plans up front
            self._plan(False)
            self._plan(True)

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
        return self._plan(False)(x, pre=self._coset if coset else None)

    def ifft(self, y: torch.Tensor, coset: bool = False) -> torch.Tensor:
        """Evaluations on (a coset of) the domain -> coefficients."""
        if self.n == 1:
            return y
        return self._plan(True)(
            y, post=self._coset_inv_ninv if coset else self._ninv)
