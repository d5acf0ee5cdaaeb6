"""Fixed-base batch scalar multiplication, and the batched affine
conversion of its result.

Counterpart of gnark_tpu.msm.fixed_base (gnark-crypto
BatchScalarMultiplicationG1/G2, the device work of Groth16 Setup): one
base point, n scalars, one double-and-add ladder over the bits, MSB
first: per bit one K7 jac_double of the accumulator and one K6
jac_add_mixed of the base. The reference's select(bit, R + base, R) is
the mixed add with the affine operand masked as infinity where the bit
is 0 (jac_add_mixed returns R there), so no third step is needed. On a
CUDA tensor the whole ladder is one launch of a kernel that fuses the
two (csrc/ladder.cu); on a CPU tensor its plain version runs the
per-bit sequence over the plain K7 and K6. The affine conversion of the
result is one launch of K1's affine kernel (csrc/mont_mul.cu,
affine_words: batch inversion); its plain version is the Fermat chain
of plain products over the batch that the reference runs.

Points are (n, Lw) int32 words (Lw = nw over Fp, 2 nw for flat rows over
Fp2; nw = 8 on BN254, 12 on BLS12-381 and BLS12-377, 24 on BW6-761, whose
G2 lies over Fp and takes the G1 kernels); scalars are (n, sw) int32
words of plain (non-Montgomery) integers, sw the words of the curve's
scalar field (csrc/mont.cuh's GT_SW: 8, 12 on BW6-761).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ec.jac_ec import (jac_add_mixed, jac_add_mixed_plain,
                                       jac_double, jac_double_plain)
from gnark_tpu_torch.ec.proj_ec import _lw, is_fp2, kernel_field, lib_field
from gnark_tpu_torch.ff import on_words
from gnark_tpu_torch.ff.mont_mul import mont_mul_plain


def jac_infinity_words(ff, n: int, device) -> tuple:
    """n Jacobian points at infinity (1, 1, 0) as words."""
    base = ff.base if is_fp2(ff) else ff
    one = base.encode_words([1] + [0] * (_lw(ff) // base.nw - 1))
    one = torch.as_tensor(one.reshape(1, -1), device=device)
    one = one.expand(n, -1).contiguous()
    return (one, one.clone(), torch.zeros_like(one))


def per_bit_ladder(ff, base_affine, nbits: int, scalars, dbl=jac_double,
                   madd=jac_add_mixed):
    """The ladder one bit at a time: per bit, R = dbl(R), then R =
    madd(R, base, ~bit). With K7 and K6 (the defaults) on the card it is
    the launch sequence that the ladder kernel fuses."""
    n = scalars.shape[0]
    bx, by = (a.reshape(1, -1) for a in base_affine)
    R = jac_infinity_words(ff, n, scalars.device)
    for b in range(nbits - 1, -1, -1):
        R = dbl(ff, R)
        bit = (scalars[:, b // 32] >> (b % 32)) & 1
        R = madd(ff, R, bx, by, bit == 0)
    return R


def batch_scalar_mul_plain(ff, base_affine, nbits: int, scalars):
    """Plain version of batch_scalar_mul: the per-bit ladder over the
    plain K7 and K6."""
    return per_bit_ladder(ff, base_affine, nbits, scalars, jac_double_plain,
                          jac_add_mixed_plain)


@functools.lru_cache(maxsize=None)
def _ladder_fn(field):
    return cuda.bind("ladder", field, "gt_ladder", 6,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def batch_scalar_mul(ff, base_affine, nbits: int, scalars: torch.Tensor):
    """[s_i] * base for each row of scalars: base_affine is (x, y), one
    affine point in words ((Lw,) or (1, Lw)), < 2p; the low nbits bits
    of each scalar count. Returns Jacobian words, canonical."""
    if scalars.dim() != 2 or scalars.dtype != torch.int32:
        raise ValueError(f"batch_scalar_mul: scalars must be (n, nw) int32 "
                         f"words, got {scalars.dtype} {tuple(scalars.shape)}")
    if not 0 <= nbits <= 32 * scalars.shape[1]:
        raise ValueError(f"batch_scalar_mul: nbits = {nbits} for scalars "
                         f"of {scalars.shape[1]} words")
    if len(base_affine) != 2 or any(a.numel() != _lw(ff)
                                    for a in base_affine):
        raise ValueError(f"batch_scalar_mul: the base must be (x, y) of "
                         f"{_lw(ff)} words each")
    if any(a.device != scalars.device for a in base_affine):
        raise ValueError("batch_scalar_mul: the base and the scalars on "
                         "different devices")
    if scalars.device.type == "cpu":
        return batch_scalar_mul_plain(ff, base_affine, nbits, scalars)
    consts = kernel_field(ff)
    n = scalars.shape[0]
    sw = cuda.kernel_field(lib_field(ff)).sw
    if nbits > 32 * sw:
        raise ValueError(f"batch_scalar_mul: nbits = {nbits} past the "
                         f"kernel's {sw}-word scalars")
    sc = cuda.dev_words(scalars, "batch_scalar_mul scalars", (n, sw))
    bx, by = (np.ascontiguousarray(a.reshape(-1).cpu().numpy()
                                   .view(np.uint32)) for a in base_affine)
    out = tuple(torch.empty((n, _lw(ff)), dtype=torch.int32,
                            device=sc.device) for _ in range(3))
    fn = _ladder_fn(lib_field(ff))
    rc = fn(sc.data_ptr(), bx.ctypes.data, by.ctypes.data,
            *(a.data_ptr() for a in out), n, nbits,
            int(is_fp2(ff)), consts.ctypes.data, cuda.stream(sc))
    cuda.check(rc, "batch_scalar_mul")
    batch_scalar_mul.launches += 1
    return out


batch_scalar_mul.launches = 0


def _inv(f, z):
    """z^(p-2) (0 -> 0) by square-and-multiply, every step one plain
    product over the whole batch."""
    r = z
    for bit in bin(f.p.modulus - 2)[3:]:
        r = mont_mul_plain(f, r, r)
        if bit == "1":
            r = mont_mul_plain(f, r, z)
    return r


def _nr_times(ff, a):
    """nr * a of base-field words, canonical (u^2 = nr in ff)."""
    f = ff.base
    return f.to_words(ff._mul_nr(f.from_words(a)))


def _mul2(ff, a, b):
    """Fp2 products of (m, 2, nw) words: the four base products at once,
    then c0 = a0 b0 + nr a1 b1 (u^2 = -1: a0 b0 - a1 b1), c1 = a0 b1 +
    a1 b0."""
    f = ff.base
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    p00, p11, p01, p10 = mont_mul_plain(f, torch.cat([a0, a1, a0, a1]),
                                        torch.cat([b0, b1, b1, b0])
                                        ).chunk(4)
    c0 = on_words(f, "sub", p00, p11) if ff._nr_small == -1 else \
        on_words(f, "add", p00, _nr_times(ff, p11))
    return torch.stack([c0, on_words(f, "add", p01, p10)], 1)


def affine_words_plain(ff, P):
    """Plain version of affine_words: the Fermat chain over the batch,
    one plain product (and for Fp2 one plain sum, negation or
    difference) at a time."""
    X, Y, Z = P
    n = Z.shape[0]
    if not is_fp2(ff):
        zi = _inv(ff, Z)
        zi2 = mont_mul_plain(ff, zi, zi)
        zi3 = mont_mul_plain(ff, zi2, zi)
        return mont_mul_plain(ff, torch.cat([X, Y]),
                              torch.cat([zi2, zi3])).chunk(2)
    f = ff.base
    X, Y, Z = (a.reshape(n, 2, f.nw) for a in (X, Y, Z))
    Zt = Z.transpose(0, 1).reshape(2 * n, f.nw)
    sq = mont_mul_plain(f, Zt, Zt)
    # the norm z0^2 - nr z1^2 (u^2 = -1: z0^2 + z1^2)
    norm = on_words(f, "add", sq[:n], sq[n:]) if ff._nr_small == -1 else \
        on_words(f, "sub", sq[:n], _nr_times(ff, sq[n:]))
    di = _inv(f, norm)
    z0, z1 = mont_mul_plain(f, Zt, torch.cat([di, di])).chunk(2)
    zi = torch.stack([z0, on_words(f, "neg", z1)], 1)
    zi2 = _mul2(ff, zi, zi)
    zi3 = _mul2(ff, zi2, zi)
    x, y = _mul2(ff, torch.cat([X, Y]), torch.cat([zi2, zi3])).chunk(2)
    return x.reshape(n, -1), y.reshape(n, -1)


@functools.lru_cache(maxsize=None)
def _affine_fn(field):
    return cuda.bind("mont_mul", field, "gt_jac_to_affine", 5,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def affine_words(ff, P):
    """Jacobian words (X, Y, Z) (n, Lw), < 2p -> canonical affine words
    (x, y) = (X / Z^2, Y / Z^3); Z = 0 gives x = y = 0. ff: Fp (G1) or
    Fp2 (G2; on the card u^2 = -1 only). On the card: one launch of K1's
    affine kernel (Montgomery's batch inversion over each thread's
    points, one Fermat inverse a thread, and the affine products)."""
    if len(P) != 3 or P[0].dim() != 2:
        raise ValueError("affine_words: P must be (X, Y, Z), each (n, Lw)")
    n = P[0].shape[0]
    if any(tuple(a.shape) != (n, _lw(ff)) for a in P):
        raise ValueError(f"affine_words: expected ({n}, {_lw(ff)}) words, "
                         f"got {[tuple(a.shape) for a in P]}")
    if any(a.device != P[0].device for a in P):
        raise ValueError("affine_words: X, Y, Z on different devices")
    if P[0].device.type == "cpu":
        return affine_words_plain(ff, P)
    out = _affine_card(ff, P)
    affine_words.launches += 1
    return out


def _affine_card(ff, P):
    n = P[0].shape[0]
    consts = kernel_field(ff)
    X, Y, Z = (cuda.dev_words(a, "affine_words") for a in P)
    x, y = torch.empty_like(X), torch.empty_like(X)
    fn = _affine_fn(lib_field(ff))
    rc = fn(X.data_ptr(), Y.data_ptr(), Z.data_ptr(), x.data_ptr(),
            y.data_ptr(), n, int(is_fp2(ff)), consts.ctypes.data,
            cuda.stream(X))
    cuda.check(rc, "affine_words")
    return x, y


affine_words.launches = 0


def jac_to_affine(ff, P):
    """Jacobian words -> (x, y, inf), canonical; infinity gives x = y = 0
    (affine_words)."""
    x, y = affine_words(ff, P)
    return x, y, (P[2] == 0).all(-1)


def batch_scalar_mul_affine(ff, base_affine, nbits: int, scalars):
    """Like batch_scalar_mul, normalized to (x, y, inf)."""
    return jac_to_affine(ff, batch_scalar_mul(ff, base_affine, nbits,
                                              scalars))
