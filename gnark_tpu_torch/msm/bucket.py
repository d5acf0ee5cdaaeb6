"""Bucket MSM: signed-digit Pippenger with kernels K4 and K9.

Counterpart of gnark_tpu.msm.bucket_kernel. Algorithm:
  * scalars -> signed c-bit digits d in [-2^(c-1), 2^(c-1)], so B =
    2^(c-1) bucket magnitudes for each of the W = ceil(nbits / c) (+1)
    windows of an nbits-bit scalar (254 on BN254, 255 on BLS12-381; the
    sign flips y);
  * K4 bucket_msm sums each (window, bucket)'s points (csrc/bucket_msm.cu:
    a counting sort of the pairs by bucket, then segment sums and folds);
  * K9 bucket_reduce (csrc/bucket_reduce.cu) turns the W*B bucket sums
    into the MSM's point: sum_w 2^(c w) sum_j (j+1) P_{w,j}, in one
    launch. There is one group of points, so no group fold.
The window width c: GNARK_TPU_MSM_C when it is set (read at each call;
the reference reads it once, at import), else 8 on the CPU (the
reference's default) and on the card the width that `_CARD_C` gives for
the number of points (from chip_smoke.py's sweep on one H100). The MSM's
value does not depend on c.
The bucket state and the epilogue are Renes-Costello projective with
identity (0 : 1 : 0); the public `msm_bucket*` return Jacobian points.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ec.proj_ec import (_limbs, _lw, _words, is_fp2,
                                        kernel_consts, lib_field, proj_add,
                                        proj_add_formula, proj_dbl_formula,
                                        proj_madd_formula)
from gnark_tpu_torch.ec.weierstrass import proj_to_jac, to_limbs, to_words
from gnark_tpu_torch.msm.pippenger import (_suffix_sums, scalar_limbs,
                                          window_digits)

C_BITS = 8                        # the reference's width; the CPU default
SEG = 32                          # pairs a K4 pass-1 thread sums at most
FOLD = 32                         # partials a K4 pass-2 thread adds at most
# The card's window width by MSM size (points at most, c), from
# chip_smoke.py's sweep of c in {8, 10, 12, 13, 14, 16} at 2^13, 2^16 and
# 2^20 + 2049 points in G1 and G2 on one H100: 8 was best or within 3%
# up to 2^16, 13 at 2^20 (the epilogue, K9, costs the same few ms at any
# size and width, so small MSMs gain nothing from wider windows); the
# same sweep over BLS12-381's 12-word points picks the same widths.
_CARD_C = ((1 << 17, 8), (1 << 30, 13))


def window_bits(n: int, device) -> int:
    """The bucket path's window width c for n points on `device`."""
    env = os.environ.get("GNARK_TPU_MSM_C")
    if env:
        c = int(env)
        if not 2 <= c <= 16:
            raise ValueError(f"GNARK_TPU_MSM_C={env}: want 2 <= c <= 16")
        return c
    if torch.device(device).type == "cpu":
        return C_BITS
    return next((c for lim, c in _CARD_C if n <= lim), _CARD_C[-1][1])


def group_b3(curve, g2: bool = False):
    """3 b mod p of the curve's G1 (y^2 = x^3 + b) or, with g2, of its
    G2 (b2: an int when G2 lies over Fp, as on BW6-761, else an Fp2
    pair): the constant of the complete projective formulas (K3, K4,
    K9). Taken by group, never by base field: BW6-761's G1 (b = -1) and
    G2 (b2 = 4) share one Fp."""
    p = curve.fp.modulus
    if not g2:
        return 3 * curve.b % p
    if curve.g2_over_fp2:
        return (3 * curve.b2[0] % p, 3 * curve.b2[1] % p)
    return 3 * curve.b2 % p


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


def group_pairs(digits: torch.Tensor, inf: torch.Tensor, seg: int = SEG,
                c: int = C_BITS):
    """Group the (point, digit) pairs by (window, bucket) key and cut
    each bucket's list into segments of at most `seg` pairs (plain
    version of K4's grouping; the kernel's is `bucket_group`).

    Returns int32 tensors: entries (point index * 2 + [digit < 0],
    sorted by key), seg_start and seg_len (one per segment, into
    entries), seg_off (W*B + 1: the segments of bucket b are
    seg_off[b] .. seg_off[b+1])."""
    W, n = digits.shape
    B = 1 << (c - 1)
    dev = digits.device
    d = digits.masked_fill(inf[None, :], 0)
    mag = d.abs()
    valid = mag > 0
    wins = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    key = (wins * B + mag - 1)[valid]
    ent = (2 * torch.arange(n, dtype=torch.int32, device=dev)[None, :]
           + (d < 0).to(torch.int32))[valid]
    entries = ent[torch.argsort(key)]
    nb = W * B
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


def _b3_limbs(ff, b3, device):
    return torch.as_tensor(ff.encode(list(b3) if is_fp2(ff) else b3),
                           device=device)


def bucket_msm_plain(ff, b3, x, y, inf, digits, c: int = C_BITS):
    """Plain version of bucket_msm over int64 limbs: the same bucket sums
    as group elements (the order of the additions, and so the projective
    representative, may differ)."""
    W = digits.shape[0]
    entries, seg_start, seg_len, seg_off = group_pairs(digits, inf, c=c)
    dev = x.device
    X, Y = _limbs(ff, x), _limbs(ff, y)
    b3l = _b3_limbs(ff, b3, dev)
    nb = W << (c - 1)
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


# ---------------------------------------------------------------------------
# K4 on the card: grouping (count, offsets, scatter), pass 1, pass 2
# ---------------------------------------------------------------------------

class Groups(NamedTuple):
    """K4's grouping of the (point, digit) pairs: the pairs of bucket b
    are entries[starts[b] : starts[b] + counts[b]]; its pass-1 segments
    are seg_off[b] .. seg_off[b+1] (at most SEG pairs each). Sized
    without a host sync: entries holds W*n slots, and nseg_max bounds
    the number of segments."""
    entries: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    seg_off: torch.Tensor
    nseg_max: int
    n: int
    W: int
    c: int


@functools.lru_cache(maxsize=None)
def _k4(fn: str, field: str):
    nptr, rest = {
        "gt_bucket_count": (3, [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int]),
        "gt_bucket_scatter": (4, [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int]),
        "gt_bucket_acc": (9, [ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]),
        "gt_bucket_segfold": (8, [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]),
    }[fn]
    return cuda.bind("bucket_msm", field, fn, nptr, rest)


def _offsets(per_bucket: torch.Tensor, seg: int) -> torch.Tensor:
    """(nb,) item counts -> (nb + 1,) int32 offsets of their segments of
    at most `seg` items."""
    nseg = (per_bucket + (seg - 1)) // seg
    return torch.cat([nseg.new_zeros(1),
                      torch.cumsum(nseg, 0, dtype=torch.int32)])


def bucket_group(digits: torch.Tensor, inf: torch.Tensor, c: int,
                 field: str) -> Groups:
    """K4's grouping on the card: a count kernel, the offsets (cumsum),
    and a scatter kernel that puts every pair in its bucket's slots (a
    counting sort; the order inside a bucket is not fixed), from the
    build of K4's source for the base field `field`."""
    W, n = digits.shape
    digits = digits.contiguous()
    inf = inf.contiguous().view(torch.uint8)
    if digits.dtype != torch.int32 or inf.shape != (n,):
        raise ValueError("bucket_group: expected (W, n) int32 digits and "
                         "(n,) inf")
    B, dev = 1 << (c - 1), digits.device
    nb = W * B
    counts = torch.zeros(nb, dtype=torch.int32, device=dev)
    cuda.check(_k4("gt_bucket_count", field)(
        digits.data_ptr(), inf.data_ptr(), counts.data_ptr(), n, W, B,
        cuda.stream(digits)), "bucket_msm count")
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    cursor = starts.clone()
    entries = torch.empty(max(W * n, 1), dtype=torch.int32, device=dev)
    cuda.check(_k4("gt_bucket_scatter", field)(
        digits.data_ptr(), inf.data_ptr(), cursor.data_ptr(),
        entries.data_ptr(), n, W, B, cuda.stream(digits)),
        "bucket_msm scatter")
    return Groups(entries, starts, counts, _offsets(counts, SEG),
                  -(-W * n // SEG) + nb, n, W, c)


def _empty_points(m: int, Lw: int, device):
    return tuple(torch.empty((max(m, 1), Lw), dtype=torch.int32,
                             device=device) for _ in range(3))


def bucket_acc(ff, b3, x, y, grp: Groups):
    """K4 pass 1: one thread per segment sums its (at most SEG) points
    with the complete mixed add. Returns the partial sums, lazy."""
    consts, b3w = kernel_consts(ff, b3)
    Lw = _lw(ff)
    part = _empty_points(grp.nseg_max, Lw, x.device)
    nb = grp.W << (grp.c - 1)
    ptrs = (x, y, grp.entries, grp.starts, grp.counts, grp.seg_off) + part
    cuda.check(_k4("gt_bucket_acc", lib_field(ff))(
        *(a.data_ptr() for a in ptrs), nb, SEG, grp.nseg_max,
        int(is_fp2(ff)), consts.ctypes.data, b3w.ctypes.data,
        cuda.stream(x)), "bucket_msm pass 1")
    return part


def bucket_fold(ff, b3, grp: Groups, part):
    """K4 pass 2: the partials of each bucket, FOLD at a time, level by
    level until each bucket has at most FOLD (a skewed bucket, with
    many points on one digit, takes more levels), then at the last level
    one thread per bucket adds the rest. Returns (W*B, Lw) canonical
    bucket sums."""
    consts, b3w = kernel_consts(ff, b3)
    Lw, dev = _lw(ff), part[0].device
    nb = grp.W << (grp.c - 1)
    off, bound = grp.seg_off, grp.nseg_max
    most = -(-grp.n // SEG)           # segments of one bucket, at most
    st = cuda.stream(part[0])
    fp2 = int(is_fp2(ff))
    fold = _k4("gt_bucket_segfold", lib_field(ff))

    def level(part, off, off2, bound, last):
        out = _empty_points(bound, Lw, dev)
        cuda.check(fold(
            *(a.data_ptr() for a in part + (off, off2) + out), nb, FOLD,
            bound, fp2, last, consts.ctypes.data, b3w.ctypes.data, st),
            "bucket_msm pass 2")
        return out

    while most > FOLD:
        off2 = _offsets(off[1:] - off[:-1], FOLD)
        bound = -(-bound // FOLD) + nb
        part = level(part, off, off2, bound, 0)
        off, most = off2, -(-most // FOLD)
    return level(part, off, torch.arange(nb + 1, dtype=torch.int32,
                                         device=dev), nb, 1)


def bucket_msm(ff, b3, x, y, inf, digits, c: int = C_BITS):
    """Bucket sums of a signed-digit MSM at window width c.

    x, y: (n, Lw) words (Lw = nw for G1, 2 nw for flat G2 rows), affine,
    Montgomery; inf: (n,) bool; digits: (W, n) int32 signed digits,
    |d| <= 2^(c-1). Returns (X, Y, Z), each (W*B, Lw) canonical words,
    B = 2^(c-1): entry w*B + j is the sum over points with
    |digit_w| = j + 1."""
    if x.device.type == "cpu":
        return bucket_msm_plain(ff, b3, x, y, inf, digits, c)
    out = _bucket_msm_card(ff, b3, x, y, inf, digits, c)
    bucket_msm.launches += 1
    return out


def _bucket_msm_card(ff, b3, x, y, inf, digits, c):
    W, n = digits.shape
    Lw = _lw(ff)
    x = cuda.dev_words(x, "bucket_msm x", (n, Lw))
    y = cuda.dev_words(y, "bucket_msm y", (n, Lw))
    if not 2 <= c <= 16:
        raise ValueError(f"bucket_msm: window width {c} not in 2..16")
    grp = bucket_group(digits, inf, c, lib_field(ff))
    return bucket_fold(ff, b3, grp, bucket_acc(ff, b3, x, y, grp))


bucket_msm.launches = 0


def digit_count(nbits: int, c: int) -> int:
    """W: the windows of signed_digits at width c."""
    W0 = -(-nbits // c)
    return W0 + (1 if (1 << (nbits - (W0 - 1) * c)) >= (1 << (c - 1)) else 0)


@functools.lru_cache(maxsize=None)
def _digits_fn(field):
    return cuda.bind("bucket_msm", field, "gt_bucket_digits", 2,
                     [ctypes.c_longlong] + [ctypes.c_int] * 3)


def bucket_digits(words: torch.Tensor, nbits: int, c: int, field: str):
    """Signed c-bit digits of plain scalars: (n, sw) int32 words -> (W,
    n) int32, the digits of signed_digits (its plain version) on their
    limbs; on the card, one kernel of K4's source as built for the base
    field `field`, whose scalars are sw words (8; 12 on BW6-761)."""
    if words.device.type == "cpu":
        return signed_digits(scalar_limbs(words), nbits, c)
    out = _digits_card(words, nbits, c, field)
    bucket_digits.launches += 1
    return out


def _digits_card(words, nbits, c, field):
    n = words.shape[0]
    sw = cuda.kernel_field(field).sw
    if not 2 <= c <= 16 or nbits > 32 * sw:
        raise ValueError(f"bucket_digits: c = {c}, nbits = {nbits}")
    words = cuda.dev_words(words, "bucket_digits scalars", (n, sw))
    W = digit_count(nbits, c)
    out = torch.empty((W, n), dtype=torch.int32, device=words.device)
    fn = _digits_fn(field)
    cuda.check(fn(words.data_ptr(), out.data_ptr(), n, c, -(-nbits // c),
                  W, cuda.stream(words)), "bucket_digits")
    return out


bucket_digits.launches = 0


# ---------------------------------------------------------------------------
# K9: the epilogue, bucket sums -> the MSM's point
# ---------------------------------------------------------------------------

def reduce_geometry(c: int):
    """(L, T, nblk) of K9 at width c: each thread runs L buckets, a block
    has T threads, a window nblk blocks (L * T * nblk = 2^(c-1)). Short
    chunks keep the chain before Horner short (2 L adds, then a lift of
    c - 1 bits); the Horner chain itself, ~c W steps, is the floor."""
    B = 1 << (c - 1)
    L = min(max(B // 512, 1), 32)
    T = min(128, B // L)
    return L, T, B // (L * T)


def bucket_reduce_plain(ff, b3, P, W: int, c: int):
    """Plain version of bucket_reduce, the reference's epilogue
    (bucket_kernel.py:372-404): per window, suffix sums of the buckets
    twice (the second's first entry is sum_j (j+1) P_j), then Horner over
    the windows from the top. The same point as the kernel as a group
    element."""
    B = 1 << (c - 1)
    b3l = _b3_limbs(ff, b3, P[0].device)
    Q = tuple(_limbs(ff, a) for a in P)
    elem = Q[0].shape[1:]

    def add(f, S, T):                   # flat (N, limbs of an element)
        return tuple(a.reshape(a.shape[0], -1) for a in proj_add_formula(
            f, tuple(a.reshape((-1,) + elem) for a in S),
            tuple(a.reshape((-1,) + elem) for a in T), b3l))

    Q = tuple(a.reshape(W, B, -1) for a in Q)
    tot = _suffix_sums(ff, _suffix_sums(ff, Q, B, 1, add), B, 1, add)
    tot = tuple(a[:, 0].reshape((W,) + elem) for a in tot)
    R = tuple(a[W - 1:W] for a in tot)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            R = proj_dbl_formula(ff, R, b3l)
        R = proj_add_formula(ff, R, tuple(a[w:w + 1] for a in tot), b3l)
    return tuple(_words(ff, a) for a in R)


@functools.lru_cache(maxsize=None)
def _k9(field):
    return cuda.bind("bucket_reduce", field, "gt_bucket_reduce", 10,
                     [ctypes.c_int] * 6 + [ctypes.c_void_p,
                                           ctypes.c_void_p])


def bucket_reduce(ff, b3, P, W: int, c: int):
    """K9: the MSM's point from its bucket sums, in one launch.

    P: (X, Y, Z), each (W*B, Lw) words < 2p, B = 2^(c-1), entry w*B + j
    the sum of window w's points with |digit| = j + 1. Returns the
    projective point sum_w 2^(c w) sum_j (j+1) P_{w,j} as (1, Lw)
    canonical words."""
    if not 2 <= c <= 16:
        raise ValueError(f"bucket_reduce: window width {c} not in 2..16")
    if P[0].device.type == "cpu":
        return bucket_reduce_plain(ff, b3, P, W, c)
    out = _bucket_reduce_card(ff, b3, P, W, c)
    bucket_reduce.launches += 1
    return out


def _bucket_reduce_card(ff, b3, P, W, c):
    Lw = _lw(ff)
    P = tuple(cuda.dev_words(a, "bucket_reduce P", (W << (c - 1), Lw))
              for a in P)
    L, T, nblk = reduce_geometry(c)
    consts, b3w = kernel_consts(ff, b3)
    dev = P[0].device
    part = _empty_points(W * nblk, Lw, dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = _empty_points(1, Lw, dev)
    ptrs = P + part + (counter,) + out
    fn = _k9(lib_field(ff))
    cuda.check(fn(*(a.data_ptr() for a in ptrs), W, c, L, T, nblk,
                  int(is_fp2(ff)), consts.ctypes.data, b3w.ctypes.data,
                  cuda.stream(P[0])), "bucket_reduce")
    return out


bucket_reduce.launches = 0


# ---------------------------------------------------------------------------
# the MSM
# ---------------------------------------------------------------------------

def _flat_points(ff, points):
    x, y, inf = points
    n = x.shape[0]
    return x.reshape(n, -1), y.reshape(n, -1), inf.reshape(n)


def _msm_device(ff, b3, points, digits, W: int, c: int):
    """One bucket MSM: K4, then K9. Returns a projective point of (1, Lw)
    canonical words."""
    x, y, inf = _flat_points(ff, points)
    P = bucket_msm(ff, b3, x, y, inf, digits, c)
    return bucket_reduce(ff, b3, P, W, c)


# K4's grouping holds a chunk's (window, point) pairs at int32 offsets
# (csrc/bucket_msm.cu: entries, starts, cursor), so one K4 call takes
# fewer than MAX_PAIRS of them.
MAX_PAIRS = (1 << 31) - 1


def chunk_plan(n: int, nbits: int, device, chunk: int | None = None):
    """[(off, end, c)]: the chunks of an MSM of n points and the window
    width of each. A chunk holds at most `chunk` points (default: all
    n), halved until its W * points < MAX_PAIRS."""
    size = chunk or max(n, 1)
    while size > 1 and digit_count(nbits, window_bits(size, device)) * \
            size >= MAX_PAIRS:
        size = -(-size // 2)
    return [(off, min(off + size, n), window_bits(min(size, n - off), device))
            for off in range(0, n, size)]


def msm_proj(ff, points, scalars, nbits: int, chunk: int | None = None, *,
             b3):
    """Projective MSM result ((1, Lw) words) of the group whose 3 b is
    b3 (group_b3), streamed in the chunks of
    chunk_plan (default: all the points in one K4 call, as long as K4's
    int32 offsets hold them; the card's memory holds a 2^20-constraint
    prove's key and buckets at once); the chunk partials are folded with
    K3."""
    x, y, inf = points
    acc = None
    for off, end, c in chunk_plan(x.shape[0], nbits, x.device, chunk):
        digits = bucket_digits(scalars[off:end], nbits, c, lib_field(ff))
        part = _msm_device(ff, b3, (x[off:end], y[off:end], inf[off:end]),
                           digits, digits.shape[0], c)
        acc = part if acc is None else proj_add(ff, b3, acc, part)
    return acc


def _to_jacobian(ff, R):
    lim = to_limbs(ff, tuple(a.reshape((1,) + _elem_shape(ff)) for a in R))
    return tuple(a[0] for a in to_words(ff, proj_to_jac(ff, lim)))


def _elem_shape(ff):
    return (2, ff.nw) if is_fp2(ff) else (ff.nw,)


def msm_bucket(ff, points, scalars, nbits: int, *, b3):
    """Single-shot bucket MSM; Jacobian result (the public contract)."""
    return msm_bucket_chunked(ff, points, scalars, nbits, b3=b3)


def msm_bucket_chunked(ff, points, scalars, nbits: int,
                       chunk: int | None = None, *, b3):
    """Chunked bucket MSM (the reference's contract: fixed-size chunks,
    partials folded; chunk=None is one chunk); Jacobian result. b3: the
    group's 3 b (group_b3)."""
    return _to_jacobian(ff, msm_proj(ff, points, scalars, nbits, chunk,
                                     b3=b3))
