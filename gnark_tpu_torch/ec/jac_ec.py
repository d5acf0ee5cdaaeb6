"""K6 jac_add_mixed and K7 jac_double: batched complete Jacobian ops.

Counterpart of gnark_tpu.ec.pallas_ec.jac_add_mixed_p / jac_double_p
(EFD madd-2007-bl with the selects of a complete add, and dbl-2009-l),
for G1 over Fp and G2 over Fp2 (the reference's kernels are G1 only).
Points are tuples (X, Y, Z) of (n, Lw) int32 word tensors, Lw = 8 for
G1 and 16 for G2 (flat rows c0 | c1); Z == 0 is infinity. Inputs may be
any representative < 2p; outputs are canonical. Kernel: csrc/jac_ec.cu.
On a CPU tensor the plain version (ec.weierstrass) runs; on a CUDA
tensor the kernel, or an error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ec import weierstrass
from gnark_tpu_torch.ec.proj_ec import (_check_point, _limbs, _lw, _words,
                                        is_fp2, kernel_field)


def jac_add_mixed_plain(ff, P, x2, y2, inf2):
    """Plain version of jac_add_mixed: words in, canonical words out."""
    n = P[0].shape[0]
    A = (_limbs(ff, x2.expand(n, -1)), _limbs(ff, y2.expand(n, -1)), inf2)
    R = weierstrass.jac_add_mixed(ff, tuple(_limbs(ff, a) for a in P), A)
    return tuple(_words(ff, a) for a in R)


def jac_double_plain(ff, P):
    R = weierstrass.jac_double(ff, tuple(_limbs(ff, a) for a in P))
    return tuple(_words(ff, a) for a in R)


@functools.lru_cache(maxsize=None)
def _madd_fn():
    return cuda.bind("jac_ec", "gt_jac_add_mixed", 9,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _dbl_fn():
    return cuda.bind("jac_ec", "gt_jac_double", 6,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def jac_add_mixed(ff, P, x2, y2, inf2):
    """Batched complete P + (x2, y2): x2, y2 are (n, Lw) affine words, or
    (1, Lw) for one point added to every row; inf2 (n,) bool marks the
    rows where the affine operand is infinity (those return P)."""
    n = P[0].shape[0]
    if x2.shape[0] not in (1, n) or y2.shape != x2.shape or \
            tuple(inf2.shape) != (n,):
        raise ValueError(f"jac_add_mixed: affine operand {tuple(x2.shape)}, "
                         f"mask {tuple(inf2.shape)} for {n} points")
    if P[0].device.type == "cpu":
        return jac_add_mixed_plain(ff, P, x2, y2, inf2)
    consts = kernel_field(ff)
    P = _check_point(ff, P, n, "jac_add_mixed P")
    m = x2.shape[0]
    x2 = cuda.dev_words(x2, "jac_add_mixed x2", (m, _lw(ff)))
    y2 = cuda.dev_words(y2, "jac_add_mixed y2", (m, _lw(ff)))
    if inf2.dtype != torch.bool or inf2.device != P[0].device:
        raise ValueError("jac_add_mixed: inf2 must be a bool tensor on "
                         "the points' device")
    inf2 = inf2.contiguous()
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    rc = _madd_fn()(*(a.data_ptr() for a in P + (x2, y2, inf2) + out), n,
                    int(m == 1 and n != 1), int(is_fp2(ff)),
                    consts.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "jac_add_mixed")
    jac_add_mixed.launches += 1
    return out


def jac_double(ff, P):
    """Batched Jacobian double 2P (infinity stays infinity)."""
    if P[0].device.type == "cpu":
        return jac_double_plain(ff, P)
    n = P[0].shape[0]
    consts = kernel_field(ff)
    P = _check_point(ff, P, n, "jac_double P")
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    rc = _dbl_fn()(*(a.data_ptr() for a in P + out), n, int(is_fp2(ff)),
                   consts.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "jac_double")
    jac_double.launches += 1
    return out


jac_add_mixed.launches = 0
jac_double.launches = 0
