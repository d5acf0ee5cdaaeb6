"""K3 proj_ec: batched complete projective add and double (a = 0).

Counterpart of gnark_tpu.ec.pallas_ec.proj_add_p / proj_double_p
(Renes-Costello-Batina 2015, Algorithms 7 and 9). Points are tuples
(X, Y, Z) of (n, Lw) int32 word tensors: Lw = nw for G1 over Fp, 2 nw
for G2 over Fp2 (flat rows c0 | c1, the reference's layout; nw = 8 on
BN254, 12 on BLS12-381). Inputs may
be any representative < 2p; outputs are canonical. Kernel:
csrc/proj_ec.cu. On a CPU tensor the plain version runs; on a CUDA
tensor the kernel, or an error.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ec.fp2 import FF2
from gnark_tpu_torch.ec.weierstrass import _many


def is_fp2(ff) -> bool:
    return isinstance(ff, FF2)


def b3_words(ff, b3) -> np.ndarray:
    """Host words of 3b in Montgomery form (nw, or 2 nw for Fp2)."""
    base = ff.base if is_fp2(ff) else ff
    vals = list(b3) if is_fp2(ff) else [b3]
    return base.encode_words(vals).reshape(-1).view(np.uint32)


def lib_field(ff) -> str:
    """The field whose kernel builds take ff (Fp, or Fp2 by its base)."""
    return (ff.base if is_fp2(ff) else ff).p.name


def kernel_field(ff):
    """Field constants for a kernel over ff (Fp, or Fp2 by its base);
    raises for a field the kernels do not take (and for an Fp2 whose
    u^2 is not the kernels')."""
    name = lib_field(ff)
    nr = cuda.kernel_field(name).nr
    if is_fp2(ff) and ff._nr_small != nr:
        raise ValueError(f"Fp2 kernels over {name} take u^2 = {nr} only")
    return cuda.field_consts(name)


def kernel_consts(ff, b3):
    """(field constants, b3 words) for a kernel over ff."""
    return kernel_field(ff), b3_words(ff, b3)


def _limbs(ff, a):
    """(n, Lw) words < 2p -> (n, L) or (n, 2, L) limbs, canonical."""
    if is_fp2(ff):
        a = a.reshape(a.shape[0], 2, ff.nw)
    return (ff.base if is_fp2(ff) else ff)._cond_sub(ff.from_words(a))


def _words(ff, a):
    return ff.to_words(a).reshape(a.shape[0], -1)


def _b3_limbs(ff, b3, device):
    vals = list(b3) if is_fp2(ff) else b3
    return torch.as_tensor(ff.encode(vals), device=device)


def _const(f, k: int, like):
    v = (k, 0) if is_fp2(f) else k
    return torch.as_tensor(f.encode(v), device=like.device)


def _sop_tail(f, t3, t1, t4, Y3, Z3, X3):
    """(t3*t1 - t4*Y3, t1*Z3 + Y3*X3, Z3*t4 + X3*t3): the three fused
    sums of products that end Algorithms 7 and 8."""
    p = _many(f, "mul", [(t3, t1), (t4, f.neg(Y3)), (t1, Z3), (Y3, X3),
                         (Z3, t4), (X3, t3)])
    return _many(f, "add", [(p[0], p[1]), (p[2], p[3]), (p[4], p[5])])


def proj_add_formula(f, P, Q, b3):
    """RC15 Algorithm 7 over canonical plain field ops (f: FF or FF2 on
    limbs). Each lazy op of the kernel is one canonical op here, so the
    results agree once the kernel canonicalizes; independent products
    are batched into one call."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2 = _many(f, "mul", [(X1, X2), (Y1, Y2), (Z1, Z2)])
    s = _many(f, "add", [(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1),
                         (X2, Z2)])
    m = _many(f, "mul", [(s[0], s[1]), (s[2], s[3]), (s[4], s[5])])
    u = _many(f, "add", [(t0, t1), (t1, t2), (t0, t2), (t0, t0)])
    t3, t4, Y3 = _many(f, "sub", [(m[0], u[0]), (m[1], u[1]),
                                  (m[2], u[2])])
    X3 = f.add(u[3], t0)                          # 3*t0
    t2, Y3 = _many(f, "mul", [(t2, b3), (Y3, b3)])
    Z3, t1 = f.add(t1, t2), f.sub(t1, t2)
    return _sop_tail(f, t3, t1, t4, Y3, Z3, X3)


def proj_madd_formula(f, P, x2, y2, b3):
    """RC15 Algorithm 8 (P + affine (x2, y2), not the identity)."""
    X1, Y1, Z1 = P
    t0, t1 = _many(f, "mul", [(X1, x2), (Y1, y2)])
    s1, s2 = _many(f, "add", [(x2, y2), (X1, Y1)])
    m1, m2, m3, t2 = _many(f, "mul", [(s1, s2), (y2, Z1), (x2, Z1),
                                      (Z1, b3)])
    u, t4, Y3, d0 = _many(f, "add", [(t0, t1), (m2, Y1), (m3, X1),
                                     (t0, t0)])
    t3 = f.sub(m1, u)
    X3 = f.add(d0, t0)                            # 3*t0
    Z3, t1 = f.add(t1, t2), f.sub(t1, t2)
    Y3 = f.mul(Y3, b3)
    return _sop_tail(f, t3, t1, t4, Y3, Z3, X3)


def proj_dbl_formula(f, P, b3):
    """RC15 Algorithm 9 (8*t0 and 3*t2 as products by constants)."""
    X, Y, Z = P
    t0, t1, zz, xy = _many(f, "mul", [(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    t2, Z3 = _many(f, "mul", [(zz, b3), (t0, _const(f, 8, Y))])
    X3, Z3, t2x3 = _many(f, "mul", [(t2, Z3), (t1, Z3),
                                    (t2, _const(f, 3, Y))])
    Y3 = f.add(t0, t2)
    t0 = f.sub(t0, t2x3)
    r1, r2 = _many(f, "mul", [(t0, Y3), (t0, xy)])
    return (f.double(r2), f.add(X3, r1), Z3)


def proj_add_plain(ff, b3, P, Q):
    """Plain version of proj_add: words in, canonical words out."""
    dev = P[0].device
    R = proj_add_formula(ff, tuple(_limbs(ff, a) for a in P),
                         tuple(_limbs(ff, a) for a in Q),
                         _b3_limbs(ff, b3, dev))
    return tuple(_words(ff, a) for a in R)


def proj_double_plain(ff, b3, P):
    dev = P[0].device
    R = proj_dbl_formula(ff, tuple(_limbs(ff, a) for a in P),
                         _b3_limbs(ff, b3, dev))
    return tuple(_words(ff, a) for a in R)


def _lw(ff) -> int:
    return 2 * ff.nw if is_fp2(ff) else ff.nw


def _check_point(ff, P, n, what):
    return tuple(cuda.dev_words(a, what, (n, _lw(ff))) for a in P)


@functools.lru_cache(maxsize=None)
def _add_fn(field):
    return cuda.bind("proj_ec", field, "gt_proj_add", 9,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _dbl_fn(field):
    return cuda.bind("proj_ec", field, "gt_proj_double", 6,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])


def proj_add(ff, b3, P, Q):
    """Batched complete projective add P + Q; b3 = 3b (int, or an int
    pair for G2)."""
    if P[0].device.type == "cpu":
        return proj_add_plain(ff, b3, P, Q)
    n = P[0].shape[0]
    consts, b3w = kernel_consts(ff, b3)
    P = _check_point(ff, P, n, "proj_add P")
    Q = _check_point(ff, Q, n, "proj_add Q")
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    fn = _add_fn(lib_field(ff))
    rc = fn(*(a.data_ptr() for a in P + Q + out), n, int(is_fp2(ff)),
            consts.ctypes.data, b3w.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "proj_add")
    proj_add.launches += 1
    return out


def proj_double(ff, b3, P):
    """Batched complete projective double 2P."""
    if P[0].device.type == "cpu":
        return proj_double_plain(ff, b3, P)
    n = P[0].shape[0]
    consts, b3w = kernel_consts(ff, b3)
    P = _check_point(ff, P, n, "proj_double P")
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    fn = _dbl_fn(lib_field(ff))
    rc = fn(*(a.data_ptr() for a in P + out), n, int(is_fp2(ff)),
            consts.ctypes.data, b3w.ctypes.data, cuda.stream(P[0]))
    cuda.check(rc, "proj_double")
    proj_double.launches += 1
    return out


proj_add.launches = 0
proj_double.launches = 0
