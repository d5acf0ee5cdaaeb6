"""Bucket MSM: signed-digit Pippenger with kernel K4 and a K3 epilogue.

Counterpart of gnark_tpu.msm.bucket_kernel. Algorithm:
  * scalars -> signed c-bit digits d in [-2^(c-1), 2^(c-1)], c = 8, so
    B = 128 bucket magnitudes for each of the W = 32 windows of a 254-bit
    scalar (the sign flips y);
  * K4 bucket_msm sums each (window, bucket)'s points (see
    csrc/bucket_msm.cu for the sort-and-segment design);
  * epilogue through K3, in the reference's order: two suffix sums over
    the 128 buckets (sum_j (j+1) P_j), then Horner over the windows with
    c doublings each. There is one group of points, so no group fold.
The bucket state and the epilogue are Renes-Costello projective with
identity (0 : 1 : 0); the public `msm_bucket*` return Jacobian points.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ec.proj_ec import (_limbs, _lw, _words, is_fp2,
                                        kernel_consts, proj_add,
                                        proj_add_formula, proj_double,
                                        proj_madd_formula)
from gnark_tpu_torch.ec.weierstrass import proj_to_jac, to_limbs, to_words
from gnark_tpu_torch.msm.pippenger import (_suffix_sums, scalar_limbs,
                                           window_digits)

C_BITS = 8
BUCKETS = 1 << (C_BITS - 1)       # bucket magnitudes per window
SEG = 32                          # pairs a K4 thread accumulates at most


@functools.lru_cache(maxsize=None)
def curve_b3(field_name: str):
    """3*b mod p for the a=0 curve whose base field is `field_name`."""
    from gnark_tpu_torch.ec import curves
    for c in curves.CURVES.values():
        if c.fp.name == field_name:
            return 3 * c.b % c.fp.modulus
    return None


@functools.lru_cache(maxsize=None)
def curve_b3_g2(field_name: str):
    """3*b2 as an Fp2 pair for the curve whose G2 twist lives over Fp2
    of `field_name`."""
    from gnark_tpu_torch.ec import curves
    for c in curves.CURVES.values():
        if c.fp.name == field_name and c.g2_over_fp2:
            p = c.fp.modulus
            return (3 * c.b2[0] % p, 3 * c.b2[1] % p)
    return None


def signed_digits(scalars: torch.Tensor, nbits: int, c: int):
    """(n, K) 16-bit limbs -> (W, n) int32 signed digits, |d| <= 2^(c-1).

    Borrow recoding: raw window t plus carry; when t >= 2^(c-1) emit
    t - 2^c and carry 1. An extra window absorbs the final carry only
    when the top raw window can actually overflow."""
    raw = window_digits(scalars, nbits, c)
    n, W0 = raw.shape
    half = 1 << (c - 1)
    full = 1 << c
    top_bits = nbits - (W0 - 1) * c
    W = W0 + (1 if (1 << top_bits) >= half else 0)
    outs = []
    carry = torch.zeros(n, dtype=torch.int32, device=scalars.device)
    for w in range(W):
        t = (raw[:, w] if w < W0 else torch.zeros_like(carry)) + carry
        hi = (t >= half).to(torch.int32)
        outs.append(t - hi * full)
        carry = hi
    return torch.stack(outs, dim=0)


def group_pairs(digits: torch.Tensor, inf: torch.Tensor, seg: int = SEG):
    """Group the (point, digit) pairs by (window, bucket) key and cut
    each bucket's list into segments of at most `seg` pairs.

    Returns int32 tensors: entries (point index * 2 + [digit < 0],
    sorted by key), seg_start and seg_len (one per segment, into
    entries), seg_off (W*B + 1: the segments of bucket b are
    seg_off[b] .. seg_off[b+1])."""
    W, n = digits.shape
    dev = digits.device
    d = digits.masked_fill(inf[None, :], 0)
    mag = d.abs()
    valid = mag > 0
    wins = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    key = (wins * BUCKETS + mag - 1)[valid]
    ent = (2 * torch.arange(n, dtype=torch.int32, device=dev)[None, :]
           + (d < 0).to(torch.int32))[valid]
    entries = ent[torch.argsort(key)]
    nb = W * BUCKETS
    counts = torch.bincount(key.long(), minlength=nb)
    starts = torch.cumsum(counts, 0) - counts
    nseg = (counts + seg - 1) // seg
    seg_off = torch.cat([nseg.new_zeros(1), torch.cumsum(nseg, 0)])
    total = int(seg_off[-1])
    seg_bucket = torch.repeat_interleave(
        torch.arange(nb, device=dev), nseg, output_size=total)
    rank = torch.arange(total, device=dev) - seg_off[seg_bucket]
    seg_start = starts[seg_bucket] + rank * seg
    seg_len = torch.clamp(counts[seg_bucket] - rank * seg, max=seg)
    i32 = torch.int32
    return (entries.to(i32).contiguous(), seg_start.to(i32),
            seg_len.to(i32), seg_off.to(i32))


def _identity(ff, shape, device):
    """Projective identity (0 : 1 : 0) over limbs, batch `shape`."""
    one = ff.ones(shape, device)
    return (torch.zeros_like(one), one.clone(), torch.zeros_like(one))


def bucket_msm_plain(ff, b3, x, y, inf, digits):
    """Plain version of bucket_msm over int64 limbs, on the same
    segments: the same bucket sums as group elements (the order of the
    additions, and so the projective representative, may differ)."""
    W = digits.shape[0]
    entries, seg_start, seg_len, seg_off = group_pairs(digits, inf)
    dev = x.device
    X, Y = _limbs(ff, x), _limbs(ff, y)
    b3l = torch.as_tensor(ff.encode(list(b3) if is_fp2(ff) else b3),
                          device=dev)
    nb = W * BUCKETS
    seg_start, seg_len = seg_start.long(), seg_len.long()

    def pairs(pos):
        e = entries[pos].long()
        py = Y[e >> 1]
        return X[e >> 1], ff.select((e & 1).bool(), ff.neg(py), py)

    # each step advances only the segments (buckets) still running
    nseg = seg_start.numel()
    acc = ()
    if nseg:
        ax, ay = pairs(seg_start)
        acc = (ax, ay, ff.ones((nseg,), dev).clone())
        for t in range(1, int(seg_len.max())):
            act = (seg_len > t).nonzero().squeeze(1)
            qx, qy = pairs(seg_start[act] + t)
            R = proj_madd_formula(ff, tuple(a[act] for a in acc), qx, qy,
                                  b3l)
            for a, r in zip(acc, R):
                a.index_copy_(0, act, r)
    out = _identity(ff, (nb,), dev)
    off = seg_off.long()
    per = off[1:] - off[:-1]
    for s in range(int(per.max()) if nb else 0):
        act = (per > s).nonzero().squeeze(1)
        R = proj_add_formula(ff, tuple(o[act] for o in out),
                             tuple(a[off[act] + s] for a in acc), b3l)
        for o, r in zip(out, R):
            o.index_copy_(0, act, r)
    return tuple(_words(ff, a) for a in out)


@functools.lru_cache(maxsize=None)
def _fn():
    return cuda.bind("bucket_msm", "gt_bucket_msm", 12,
                     [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])


def bucket_msm(ff, b3, x, y, inf, digits):
    """Bucket sums of a signed-digit MSM.

    x, y: (n, Lw) words (Lw = 8 for G1, 16 for flat G2 rows), affine,
    Montgomery; inf: (n,) bool; digits: (W, n) int32 signed digits.
    Returns (X, Y, Z), each (W*128, Lw) canonical words: entry
    w*128 + j is the sum over points with |digit_w| = j + 1."""
    W, n = digits.shape
    if x.device.type == "cpu":
        return bucket_msm_plain(ff, b3, x, y, inf, digits)
    consts, b3w = kernel_consts(ff, b3)
    Lw = _lw(ff)
    x = cuda.dev_words(x, "bucket_msm x", (n, Lw))
    y = cuda.dev_words(y, "bucket_msm y", (n, Lw))
    entries, seg_start, seg_len, seg_off = group_pairs(digits, inf)
    nseg, nb = seg_start.numel(), W * BUCKETS
    part = tuple(torch.empty((max(nseg, 1), Lw), dtype=torch.int32,
                             device=x.device) for _ in range(3))
    out = tuple(torch.empty((nb, Lw), dtype=torch.int32, device=x.device)
                for _ in range(3))
    ptrs = (x, y, entries, seg_start, seg_len) + part + (seg_off,) + out
    rc = _fn()(*(a.data_ptr() for a in ptrs), nseg, nb, int(is_fp2(ff)),
               consts.ctypes.data, b3w.ctypes.data, cuda.stream(x))
    cuda.check(rc, "bucket_msm")
    bucket_msm.launches += 1
    return out


bucket_msm.launches = 0


def _flat_points(ff, points):
    x, y, inf = points
    n = x.shape[0]
    return x.reshape(n, -1), y.reshape(n, -1), inf.reshape(n)


def _b3(ff):
    b3 = curve_b3_g2(ff.p.name) if is_fp2(ff) else curve_b3(ff.p.name)
    if b3 is None:
        raise ValueError(f"no a=0 curve registered for base field "
                         f"{ff.p.name}")
    return b3


def _msm_device(ff, points, digits, W: int):
    """One bucket MSM: K4, then the K3 epilogue. Returns a projective
    point of (1, Lw) canonical words."""
    b3 = _b3(ff)
    x, y, inf = _flat_points(ff, points)
    Lw = x.shape[1]
    dev = x.device
    P = tuple(a.reshape(W, BUCKETS, Lw)
              for a in bucket_msm(ff, b3, x, y, inf, digits))
    ident = tuple(_words(ff, a) for a in _identity(ff, (1,), dev))

    def add(f, S, Q):
        return proj_add(f, b3, S, Q)

    suf = _suffix_sums(ff, P, BUCKETS, 1, add)
    tot = _suffix_sums(ff, suf, BUCKETS, 1, add)
    tot = tuple(a[:, 0] for a in tot)                   # (W, Lw)
    R = ident
    for i in range(W):
        for _ in range(C_BITS):
            R = proj_double(ff, b3, R)
        R = proj_add(ff, b3, R, tuple(a[W - 1 - i][None] for a in tot))
    return R


def msm_proj(ff, points, scalars, nbits: int, chunk: int | None = None):
    """Projective MSM result ((1, Lw) words) streamed in chunks of at
    most `chunk` points (default: all of them in one K4 call; the card's
    memory holds a 2^20-constraint prove's key and buckets at once); the
    chunk partials are folded with K3."""
    x, y, inf = points
    n = x.shape[0]
    chunk = chunk or max(n, 1)
    acc = None
    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        digits = signed_digits(scalar_limbs(scalars[off:end]), nbits,
                               C_BITS)
        part = _msm_device(ff, (x[off:end], y[off:end], inf[off:end]),
                           digits, digits.shape[0])
        acc = part if acc is None else proj_add(ff, _b3(ff), acc, part)
    return acc


def _to_jacobian(ff, R):
    lim = to_limbs(ff, tuple(a.reshape((1,) + _elem_shape(ff)) for a in R))
    return tuple(a[0] for a in to_words(ff, proj_to_jac(ff, lim)))


def _elem_shape(ff):
    return (2, ff.nw) if is_fp2(ff) else (ff.nw,)


def msm_bucket(ff, points, scalars, nbits: int):
    """Single-shot bucket MSM; Jacobian result (the public contract)."""
    return msm_bucket_chunked(ff, points, scalars, nbits)


def msm_bucket_chunked(ff, points, scalars, nbits: int,
                       chunk: int | None = None):
    """Chunked bucket MSM (the reference's contract: fixed-size chunks,
    partials folded; chunk=None is one chunk); Jacobian result."""
    return _to_jacobian(ff, msm_proj(ff, points, scalars, nbits, chunk))
