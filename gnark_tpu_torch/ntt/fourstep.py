"""Four-step (Bailey) NTT over word tensors, with kernel K2.

Counterpart of gnark_tpu.ntt.fourstep. Split n = n1 * S (S = 2^ceil(k/2)
points a row, n1 <= S rows). With j = j2*n1 + j1 and k = k1*S + k2:

    X[k1*S + k2] = DFT_n1 over j1 ( w^(j1*k2) * DFT_S over j2 (x)[j1, k2] )

On the card a whole transform is `fourstep_ntt`, two launches of
csrc/row_fft.cu (more for rows longer than a block's shared memory,
past 2^24 points):
  * pass 1: the n1 columns x[j2*n1 + j1] read in place (the transpose
    folded into the load, an optional pre-scale such as a coset's powers
    on load), radix-2 DIF over each (bit-reversed out), times the mid
    twiddle on the way out, stored transposed, (S, n1);
  * pass 2: the S rows of n1 points, each output written straight to its
    natural-order place out[rev_n1(p)*S + rev_S(q)], with an optional
    post-scale (n^-1, or a coset iFFT's n^-1 g^-i) on store.
Its plain twin `fourstep_ntt_plain` is the sequence the kernels replace:
a transpose, `row_fft_plain`, the mid product, a transpose,
`row_fft_plain`, two gathers and a transpose, with the scalings as plain
products. `row_fft` (all DIF stages of contiguous rows, no fusion) stays
an entry point on the same kernel.

Rows longer than 2^seg_log(nw) points (2^SMEM_LOG at 8 words, 2^11 at
12) do not fit a block's shared memory: `row_plan` runs their first
stages as register passes over global memory and the rest in shared
memory on independent segments of that length.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import FF
from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain

SMEM_LOG = 12          # the longest row segment a block holds (8 words)
PASS_MAX = 3           # stages of one global register pass
SMEM_LIMIT = 232448    # dynamic shared memory one H100 block may use


def bitrev(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def mont_powers(ff: FF, ws, n: int, scale: int = 1) -> np.ndarray:
    """(len(ws) * n, nw) int32 words: row r holds scale * ws[r]^i for
    i < n, Montgomery, canonical. The values are made in Montgomery form
    directly (each the last times a plain power, mod p), so no element
    is converted."""
    q = ff.p.modulus
    nb = 4 * ff.nw
    start = scale * ff.p.R_mod % q

    def values():
        for w in ws:
            x = start
            for _ in range(n):
                yield x
                x = x * w % q

    it = values()
    total = len(ws) * n
    out = np.empty((total, ff.nw), dtype=np.int32)
    for o in range(0, total, 1 << 16):
        m = min(1 << 16, total - o)
        buf = b"".join(v.to_bytes(nb, "little")
                       for v in itertools.islice(it, m))
        out[o:o + m] = np.frombuffer(buf, dtype="<i4").reshape(m, ff.nw)
    return out


def power_table(ff: FF, ws, n: int, device, scale: int = 1) -> torch.Tensor:
    """mont_powers on the device for n a power of two: the first columns
    (4,096 values in all at most) made on the host, then the rest by
    doubling, T[:, m:2m] = T[:, :m] * ws^m, each step one K1 product
    (its plain version on the CPU)."""
    q = ff.p.modulus
    R = len(ws)
    m = min(n, max(1, 4096 // R))
    T = torch.as_tensor(mont_powers(ff, ws, m, scale),
                        device=device).reshape(R, m, ff.nw)
    while m < n:
        step = torch.as_tensor(ff.encode_words([pow(w, m, q) for w in ws]),
                               device=device)
        if R > 1:
            step = step[:, None].expand(R, m, ff.nw)
        T = torch.cat([T, mont_mul(ff, T, step)], dim=1)
        m *= 2
    return T.reshape(R * n, ff.nw)


def root_powers(ff: FF, m: int, w: int) -> np.ndarray:
    """(max(m/2, 1), nw) words: w^i for i < m/2, w an m-th root (the
    twiddles of every DIF stage of a row of m: stage s reads w^(j 2^s))."""
    return mont_powers(ff, [w], max(m // 2, 1))


def seg_log(nw: int = 8) -> int:
    """The longest row segment (its log2) a block holds on chip at nw
    words an element: SMEM_LOG, less where its shared memory would pass
    SMEM_LIMIT (12 words: 2^11, 159,744 B; 2^12 would take 319,488)."""
    G = SMEM_LOG
    while G > 1 and seg_smem_bytes(G, nw) > SMEM_LIMIT:
        G -= 1
    return G


def row_plan(S: int, nw: int = 8) -> tuple:
    """(the stage counts of the global register passes, the segment log
    G) for rows of S = 2^L points of nw words: every stage past
    2^seg_log(nw) (the first L - G) in passes of at most PASS_MAX
    stages, the last G in shared memory on segments of 2^G."""
    L = S.bit_length() - 1
    G = min(L, seg_log(nw))
    g, passes = L - G, []
    while g > 0:
        passes.append(min(PASS_MAX, g))
        g -= passes[-1]
    return tuple(passes), G


def seg_smem_bytes(G: int, nw: int = 8) -> int:
    """Dynamic shared memory of one segment block at nw words an
    element, a copy of csrc/row_fft.cu's fs_smem (the card tests hold it
    to the kernel's gt_fs_smem in each build): the points with a pad
    word every 8 (when the segment has more than one stage) and the
    segment root's 2^(G-1) powers."""
    n = 1 << G
    pts = nw * (n + n // 8) if G > 1 else 0
    return (pts + nw * (n // 2)) * 4


def fourstep_shape(n: int) -> tuple:
    """(S, n1): rows of S = 2^ceil(k/2) points in pass 1, n1 = n / S in
    pass 2."""
    k = n.bit_length() - 1
    S = 1 << ((k + 1) // 2)
    return S, n // S


def tw_fold(e: np.ndarray) -> np.ndarray:
    """Where twiddle e sits in a word plane of the kernel's shared table:
    the low five bits XOR-folded with the higher ones (row_fft.cu
    tw_pos)."""
    return (e & ~31) | ((e ^ (e >> 5) ^ (e >> 10) ^ (e >> 15)) & 31)


def seg_table(pw: torch.Tensor, L: int, G: int) -> torch.Tensor:
    """The kernel's twiddle table for the last G stages of a 2^L row
    whose root powers are pw ((2^(L-1), nw), natural order): the
    2^(G-1) powers of the segment root w^(2^(L-G)), word-major, each at
    its tw_fold place; a flat contiguous word tensor."""
    half = max(1 << (G - 1), 1)
    t = pw[::1 << (L - G)][:half]
    pos = torch.as_tensor(tw_fold(np.arange(half)), device=pw.device)
    out = torch.empty((pw.shape[1], half), dtype=pw.dtype, device=pw.device)
    out[:, pos] = t.transpose(0, 1)
    return out.reshape(-1)


def row_fft_plain(ff: FF, x: torch.Tensor, pw: torch.Tensor):
    """Plain version of row_fft over int64 limbs: every DIF stage of
    each row, bit-reversed canonical output; pw: the row root's powers
    (root_powers)."""
    rows, S, _ = x.shape
    k = S.bit_length() - 1
    X = ff.canon(ff.from_words(x))
    P = ff.from_words(pw)
    L = ff.n
    for s in range(k):
        m = S >> s
        half = m >> 1
        Xr = X.reshape(rows, S // m, 2, half, L)
        u, v = Xr[:, :, 0], Xr[:, :, 1]
        w = P[::1 << s][:half]
        X = torch.stack([ff.add(u, v), ff.mul(ff.sub(u, v), w)],
                        dim=2).reshape(rows, S, L)
    return ff.to_words(X)


@functools.lru_cache(maxsize=None)
def _seg_fn(field):
    return cuda.bind("row_fft", field, "gt_fs_seg", 5,
                     [ctypes.c_longlong] * 5 + [ctypes.c_int] * 5 +
                     [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _pass_fn(field):
    return cuda.bind("row_fft", field, "gt_fs_pass", 4,
                     [ctypes.c_longlong] * 5 + [ctypes.c_int] * 3 +
                     [ctypes.c_void_p])


def _rows_card(ff, src, src_s, pre, dst, dst_s, post, bcast, rows, L, pw,
               seg_tw, rplan, orev=(0, 0)):
    """Launch the DIF of `rows` rows of 2^L points: point e of row r at
    src[r src_s[0] + e src_s[1]] (times pre at the same place), output
    position p at dst[orow(r) dst_s[0] + oel(p) dst_s[1]] (times post
    there, or post[0] if bcast); rplan: row_plan(2^L). Returns the number
    of launches."""
    consts = cuda.field_consts(ff.p.name).ctypes.data
    st = cuda.stream(src)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    passes, G = rplan
    if passes:
        buf = torch.empty((rows << L, ff.nw), dtype=torch.int32,
                          device=src.device)
        s0 = 0
        for r in passes:
            cuda.check(_pass_fn(ff.p.name)(
                src.data_ptr(), ptr(pre), buf.data_ptr(), pw.data_ptr(),
                src_s[0], src_s[1], 1 << L, 1, rows, L, s0, r, consts, st),
                "fourstep pass")
            src, src_s, pre = buf, (1 << L, 1), None
            s0 += r
    cuda.check(_seg_fn(ff.p.name)(
        src.data_ptr(), ptr(pre), dst.data_ptr(), ptr(post),
        seg_tw.data_ptr(), src_s[0], src_s[1], dst_s[0], dst_s[1], rows, L,
        G, orev[0], orev[1], int(bcast), consts, st),
        "fourstep seg")
    return len(passes) + 1


def row_fft(ff: FF, x: torch.Tensor, pw: torch.Tensor,
            tw: torch.Tensor | None = None) -> torch.Tensor:
    """x: (rows, S, nw) words < 2p, contiguous rows; pw: the row root's
    powers (root_powers, (S/2, nw)); tw: the kernel's table for them,
    seg_table(pw, log2 S, row_plan(S, nw)[1]), made here when None (a caller
    that repeats a row length passes it, as FourStep does). All log2 S
    DIF stages of each row; output bit-reversed within each row,
    canonical."""
    rows, S, nw = x.shape
    k = S.bit_length() - 1
    if S != 1 << k or tuple(pw.shape) != (max(S // 2, 1), nw) or \
            nw != ff.nw:
        raise ValueError(f"row_fft: bad shapes x {tuple(x.shape)}, "
                         f"pw {tuple(pw.shape)}")
    if x.device.type == "cpu":
        return row_fft_plain(ff, x, pw)
    if S < 2:
        raise ValueError("row_fft: rows of one point on the card")
    return _row_fft_card(ff, x, pw, tw)


def _row_fft_card(ff, x, pw, tw):
    rows, S, _ = x.shape
    k = S.bit_length() - 1
    x = cuda.dev_words(x, "row_fft x")
    pw = cuda.dev_words(pw, "row_fft pw")
    out = torch.empty_like(x)
    rplan = row_plan(S, ff.nw)
    tw = seg_table(pw, k, rplan[1]) if tw is None else \
        cuda.dev_words(tw, "row_fft tw")
    row_fft.launches += _rows_card(ff, x, (S, 1), None, out, (S, 1), None,
                                   False, rows, k, pw, tw, rplan)
    return out


row_fft.launches = 0


class FourStep:
    """Precomputed four-step plan for one (field, n, omega) triple: the
    row roots' powers, the kernel's segment tables and the mid twiddle,
    stored as pass 1 writes its output: mid_t[p, j1] = w^(j1 rev_S(p)),
    (S * n1, nw)."""

    def __init__(self, ff: FF, n: int, w: int, device):
        self.ff = ff
        self.n = n
        q = ff.p.modulus
        self.S, self.n1 = fourstep_shape(n)
        S, n1 = self.S, self.n1

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.pw = [dev(root_powers(ff, m, pow(w, n // m, q)))
                   for m in (S, n1)]
        self.rplan = [row_plan(m, ff.nw) for m in (S, n1)]
        self.tw = [seg_table(p, m.bit_length() - 1, rp[1])
                   for p, m, rp in zip(self.pw, (S, n1), self.rplan)]
        self.mid_t = power_table(ff, [pow(w, int(r), q) for r in bitrev(S)],
                                 n1, device)

    def __call__(self, x: torch.Tensor, pre=None, post=None) -> torch.Tensor:
        """x: (n, nw) words -> DFT in natural order, canonical. pre: (n,
        nw) words multiplied into x first; post: (n, nw) or (1, nw) words
        multiplied into the result."""
        return fourstep_ntt(self, x, pre, post)


def fourstep_ntt_plain(plan: FourStep, x, pre=None, post=None):
    """Plain version of fourstep_ntt: the transposes, plain row FFTs, mid
    product and order-fixing gathers, with the scalings as plain
    products."""
    ff = plan.ff
    n1, S, nw = plan.n1, plan.S, ff.nw
    if pre is not None:
        x = mont_mul_plain(ff, x, pre)
    A = x.reshape(S, n1, nw).permute(1, 0, 2).contiguous()
    Y = row_fft_plain(ff, A, plan.pw[0])         # (n1, S) k2 bit-reversed
    Z = mont_mul_plain(ff, Y, plan.mid_t.reshape(S, n1, nw)
                       .permute(1, 0, 2))
    Zt = Z.permute(1, 0, 2).contiguous()         # (S, n1)
    W = row_fft_plain(ff, Zt, plan.pw[1])        # (S, n1) k1 bit-reversed
    dev = x.device
    B = W.index_select(0, torch.as_tensor(bitrev(S), device=dev))
    D = B.permute(1, 0, 2).index_select(0, torch.as_tensor(bitrev(n1),
                                                           device=dev))
    out = D.reshape(plan.n, nw)
    if post is not None:
        out = mont_mul_plain(ff, out, post)
    return out


def fourstep_ntt(plan: FourStep, x, pre=None, post=None) -> torch.Tensor:
    """The four-step transform of x ((n, nw) words < 2p) with an
    optional pre-scale ((n, nw)) and post-scale ((n, nw) or (1, nw)):
    natural order, canonical. On the card two launches of K2 (one more a
    global pass for rows past 2^seg_log(nw))."""
    ff = plan.ff
    n, nw = plan.n, ff.nw
    if tuple(x.shape) != (n, nw) or \
            (pre is not None and tuple(pre.shape) != (n, nw)) or \
            (post is not None and post.shape[0] not in (1, n)):
        raise ValueError(f"fourstep_ntt: x {tuple(x.shape)}, pre "
                         f"{None if pre is None else tuple(pre.shape)}, "
                         f"post {None if post is None else tuple(post.shape)}"
                         f" for n = {n}")
    if x.device.type == "cpu":
        return fourstep_ntt_plain(plan, x, pre, post)
    return _fourstep_card(plan, x, pre, post)


def _fourstep_card(plan, x, pre, post):
    ff = plan.ff
    n, S, n1 = plan.n, plan.S, plan.n1
    x = cuda.dev_words(x, "fourstep_ntt x")
    if pre is not None:
        pre = cuda.dev_words(pre, "fourstep_ntt pre")
    if post is not None:
        post = cuda.dev_words(post, "fourstep_ntt post")
    L1, L2 = S.bit_length() - 1, n1.bit_length() - 1
    zt = torch.empty_like(x)
    k = _rows_card(ff, x, (1, n1), pre, zt, (1, n1), plan.mid_t, False, n1,
                   L1, plan.pw[0], plan.tw[0], plan.rplan[0])
    out = torch.empty_like(x)
    k += _rows_card(ff, zt, (n1, 1), None, out, (1, S), post,
                    post is not None and post.shape[0] == 1 and n != 1, S,
                    L2, plan.pw[1], plan.tw[1], plan.rplan[1], (L1, L2))
    fourstep_ntt.launches += k
    return out


fourstep_ntt.launches = 0
