"""Four-step (Bailey) NTT over word tensors, with kernel K2 row_fft.

Counterpart of gnark_tpu.ntt.fourstep. Split n = n1 * S (S = 2^ceil(k/2)
points a row, n1 <= S rows). With j = j2*n1 + j1 and k = k1*S + k2:

    X[k1*S + k2] = DFT_n1 over j1 ( w^(j1*k2) * DFT_S over j2 (x)[j1, k2] )

  * pass 1: n1 independent S-point row FFTs (K2, radix-2 DIF: natural
    in, bit-reversed out; the mid twiddle table absorbs the reversal);
  * mid twiddle: one elementwise product (K1);
  * pass 2: K2 over the transposed matrix, rows of n1 points;
  * order fix: two row gathers and a transpose (torch index_select and
    permute).

Rows are (rows, S, nw) int32 words, element-major, so one row is S * 32
contiguous bytes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import FF
from gnark_tpu_torch.ff.mont_mul import mont_mul


def bitrev(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _powers(w: int, n: int, q: int) -> list:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * w % q
    return out


def dif_stage_tw(ff: FF, S: int, w: int) -> np.ndarray:
    """(stages, S, nw) per-position DIF twiddle words, Montgomery: 1 on
    the top half of each block, w_m^(i mod half) on the bottom half."""
    q = ff.p.modulus
    k = S.bit_length() - 1
    vals = []
    for s in range(k):
        m = S >> s
        half = m >> 1
        wp = _powers(pow(w, S // m, q), half, q)
        for i in range(S):
            j = i % m
            vals.append(wp[j - half] if j >= half else 1)
    return ff.encode_words(vals).reshape(k, S, ff.nw)


def row_fft_plain(ff: FF, x: torch.Tensor, tw: torch.Tensor):
    """Plain version of row_fft over int64 limbs: every DIF stage of
    each row, bit-reversed canonical output."""
    rows, S, _ = x.shape
    k = S.bit_length() - 1
    X = ff.canon(ff.from_words(x))
    T = ff.from_words(tw)
    L = ff.n
    for s in range(k):
        m = S >> s
        half = m >> 1
        Xr = X.reshape(rows, S // m, 2, half, L)
        u, v = Xr[:, :, 0], Xr[:, :, 1]
        w = T[s].reshape(S // m, 2, half, L)[:, 1]
        X = torch.stack([ff.add(u, v), ff.mul(ff.sub(u, v), w)],
                        dim=2).reshape(rows, S, L)
    return ff.to_words(X)


@functools.lru_cache(maxsize=None)
def _fn():
    return cuda.bind("row_fft", "gt_row_fft", 3,
                     [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def row_fft(ff: FF, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """x: (rows, S, nw) words < 2p; tw: (log2 S, S, nw) stage twiddles.
    All log2 S DIF stages per row; output bit-reversed within each row,
    canonical."""
    rows, S, nw = x.shape
    k = S.bit_length() - 1
    if S != 1 << k or tuple(tw.shape) != (k, S, nw) or nw != ff.nw:
        raise ValueError(f"row_fft: bad shapes x {tuple(x.shape)}, "
                         f"tw {tuple(tw.shape)}")
    if x.device.type == "cpu":
        return row_fft_plain(ff, x, tw)
    consts = cuda.field_consts(ff.p.name)
    x = cuda.dev_words(x, "row_fft x")
    twp = cuda.dev_words(tw, "row_fft tw") if k else x
    out = torch.empty_like(x)
    rc = _fn()(x.data_ptr(), out.data_ptr(), twp.data_ptr(), rows, S, k,
               consts.ctypes.data, cuda.stream(x))
    cuda.check(rc, "row_fft")
    row_fft.launches += 1
    return out


row_fft.launches = 0


class FourStep:
    """Precomputed four-step plan for one (field, n, omega) triple."""

    def __init__(self, ff: FF, n: int, w: int, device):
        self.ff = ff
        self.n = n
        q = ff.p.modulus
        k = n.bit_length() - 1
        self.S = 1 << ((k + 1) // 2)            # row length (pass 1)
        self.n1 = n // self.S                   # number of rows
        S, n1 = self.S, self.n1

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.tw_rows = dev(dif_stage_tw(ff, S, pow(w, n // S, q)))
        self.tw_rows2 = (dev(dif_stage_tw(ff, n1, pow(w, n // n1, q)))
                         if n1 != S else self.tw_rows)
        # mid twiddle with the pass-1 bit reversal baked in:
        # M[j1, pos] = w^(j1 * rev_S(pos))
        rev = bitrev(S)
        pw = np.asarray(_powers(w, n, q), dtype=object)
        e = (np.arange(n1)[:, None] * rev[None, :]) % n
        self.mid = dev(ff.encode_words(pw[e.reshape(-1)])
                       .reshape(n1, S, ff.nw))
        self.rev_S = dev(rev)
        self.rev_n1 = dev(bitrev(n1))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, nw) words -> DFT in natural order, canonical."""
        ff = self.ff
        n1, S, nw = self.n1, self.S, ff.nw
        A = x.reshape(S, n1, nw).permute(1, 0, 2).contiguous()
        Y = row_fft(ff, A, self.tw_rows)        # (n1, S) k2 bit-reversed
        Z = mont_mul(ff, Y, self.mid)
        Zt = Z.permute(1, 0, 2).contiguous()    # (S, n1)
        W = row_fft(ff, Zt, self.tw_rows2)      # (S, n1) k1 bit-reversed
        B = W.index_select(0, self.rev_S)
        D = B.permute(1, 0, 2).index_select(0, self.rev_n1)
        return D.reshape(self.n, nw)
