"""K6 jac_add_mixed, K7 jac_double, K8 jac_add and jac_fold: batched
complete Jacobian ops.

Counterpart of gnark_tpu.ec.pallas_ec.jac_add_mixed_p / jac_double_p /
jac_add_p (EFD madd-2007-bl and add-2007-bl with the selects of a
complete add, and dbl-2009-l), for G1 over Fp and G2 over Fp2 (the
reference's kernels are G1 only).
Points are tuples (X, Y, Z) of (n, Lw) int32 word tensors, Lw = nw for
G1 and 2 nw for G2 (flat rows c0 | c1; nw = 8 on BN254, 12 on
BLS12-381); Z == 0 is infinity. Inputs may be
any representative < 2p; outputs are canonical. Kernel: csrc/jac_ec.cu.
jac_fold is K8's formula over the scan-path MSM's group fold: each bucket
column's G points summed left to right in one launch.
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
                                        is_fp2, kernel_field, lib_field)


def jac_add_mixed_plain(ff, P, x2, y2, inf2):
    """Plain version of jac_add_mixed: words in, canonical words out."""
    n = P[0].shape[0]
    A = (_limbs(ff, x2.expand(n, -1)), _limbs(ff, y2.expand(n, -1)), inf2)
    R = weierstrass.jac_add_mixed(ff, tuple(_limbs(ff, a) for a in P), A)
    return tuple(_words(ff, a) for a in R)


def jac_double_plain(ff, P):
    R = weierstrass.jac_double(ff, tuple(_limbs(ff, a) for a in P))
    return tuple(_words(ff, a) for a in R)


def jac_add_plain(ff, P, Q):
    """Plain version of jac_add: words in, canonical words out."""
    R = weierstrass.jac_add(ff, tuple(_limbs(ff, a) for a in P),
                            tuple(_limbs(ff, a) for a in Q))
    return tuple(_words(ff, a) for a in R)


def jac_fold_plain(ff, P, G, B):
    """Plain version of jac_fold: acc = P_0, then acc = jac_add(acc, P_g)
    for g = 1 .. G - 1, on canonical words."""
    Lw = P[0].shape[1]
    W = P[0].shape[0] // (G * B)
    cols = [a.reshape(W, G, B, Lw) for a in P]
    acc = tuple(a[:, 0].reshape(-1, Lw) for a in cols)
    for g in range(1, G):
        acc = jac_add_plain(ff, acc, tuple(a[:, g].reshape(-1, Lw)
                                           for a in cols))
    return tuple(_words(ff, _limbs(ff, a)) for a in acc)


@functools.lru_cache(maxsize=None)
def _fold_fn(field):
    return cuda.bind("jac_ec", field, "gt_jac_fold", 6,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _add_fn(field):
    return cuda.bind("jac_ec", field, "gt_jac_add", 9,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _madd_fn(field):
    return cuda.bind("jac_ec", field, "gt_jac_add_mixed", 9,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _dbl_fn(field):
    return cuda.bind("jac_ec", field, "gt_jac_double", 6,
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
    fn = _madd_fn(lib_field(ff))
    rc = fn(*(a.data_ptr() for a in P + (x2, y2, inf2) + out), n,
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
    fn = _dbl_fn(lib_field(ff))
    rc = fn(*(a.data_ptr() for a in P + out), n, int(is_fp2(ff)),
            consts.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "jac_double")
    jac_double.launches += 1
    return out


def jac_add(ff, P, Q):
    """Batched complete Jacobian P + Q (either may be infinity)."""
    if P[0].device.type == "cpu":
        return jac_add_plain(ff, P, Q)
    return _add_card(ff, P, Q)


def _add_card(ff, P, Q):
    n = P[0].shape[0]
    consts = kernel_field(ff)
    P = _check_point(ff, P, n, "jac_add P")
    Q = _check_point(ff, Q, n, "jac_add Q")
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    fn = _add_fn(lib_field(ff))
    rc = fn(*(a.data_ptr() for a in P + Q + out), n, int(is_fp2(ff)),
            consts.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "jac_add")
    jac_add.launches += 1
    return out


def jac_fold(ff, P, G, B):
    """The scan path's group fold: P, three (W*G*B, Lw) word tensors,
    row (w*G + g)*B + b holding bucket b of group g in window w ->
    three (W*B, Lw): row w*B + b the sum over g of those rows, added left
    to right (the sum of a column at infinity is infinity)."""
    N = P[0].shape[0]
    if G < 1 or B < 1 or N % (G * B):
        raise ValueError(f"jac_fold: {N} rows are not W*G*B rows, G = {G}, "
                         f"B = {B}")
    if P[0].device.type == "cpu":
        return jac_fold_plain(ff, P, G, B)
    return _fold_card(ff, P, G, B)


def _fold_card(ff, P, G, B):
    N = P[0].shape[0]
    consts = kernel_field(ff)
    P = _check_point(ff, P, N, "jac_fold P")
    ncol = N // G
    out = tuple(P[0].new_empty((ncol, P[0].shape[1])) for _ in range(3))
    fn = _fold_fn(lib_field(ff))
    rc = fn(*(a.data_ptr() for a in P + out), ncol, G, B, int(is_fp2(ff)),
            consts.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "jac_fold")
    jac_fold.launches += 1
    return out


jac_add_mixed.launches = 0
jac_double.launches = 0
jac_add.launches = 0
jac_fold.launches = 0
