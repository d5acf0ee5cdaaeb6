"""Radix-2 DIT NTT over word tensors, with kernel K5.

Counterpart of gnark_tpu.ntt.domain._ntt_kernel: a bit-reverse gather,
then log2 n stages; stage s (m = 2^s, half = m/2) maps each block of m
elements (e | o) to (e + o*tw | e - o*tw) with tw[j] = w_m^j, w_m = w^(n/m).
The reference runs each stage as one pallas_call
(gnark_tpu.ff.pallas_ops.butterfly_p). Here the whole transform is
`radix2_ntt` (csrc/butterfly.cu): one launch that gathers, and runs the
first ten stages of each 1,024-point segment in shared memory, and for
n > 2^10 one launch for each further three stages (two launches up to
2^13). `butterfly`, one stage in place, stays as a tested helper.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import FF
from gnark_tpu_torch.ff.mont_mul import mont_mul
from gnark_tpu_torch.ntt.fourstep import bitrev, mont_powers

SEG_LOG = 10                      # stages of gt_ntt_seg, in shared memory
PASS_MAX = 3                      # stages of one gt_ntt_pass, in registers


def stage_twiddles(ff: FF, n: int, w: int) -> list:
    """Per-stage twiddle words, Montgomery: stage s is (2^(s-1), nw)."""
    q = ff.p.modulus
    k = n.bit_length() - 1
    return [mont_powers(ff, [pow(w, n >> s, q)], 1 << (s - 1))
            for s in range(1, k + 1)]


def ntt_launches(n: int) -> int:
    """K5 launches of one radix2_ntt of n points."""
    k = n.bit_length() - 1
    return 1 + -(-max(k - SEG_LOG, 0) // PASS_MAX)


def butterfly_plain(ff: FF, y: torch.Tensor, tw: torch.Tensor):
    """Plain version of butterfly over int64 limbs; writes y."""
    n, half = y.shape[0], tw.shape[0]
    m = 2 * half
    Y = ff.canon(ff.from_words(y)).reshape(n // m, m, ff.n)
    e, o = Y[:, :half], Y[:, half:]
    t = ff.mul(o, ff.from_words(tw)[None])
    out = torch.cat([ff.add(e, t), ff.sub(e, t)], dim=1)
    y.copy_(ff.to_words(out).reshape(n, ff.nw))
    return y


@functools.lru_cache(maxsize=None)
def _pass_fn(field):
    return cuda.bind("butterfly", field, "gt_ntt_pass", 2,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _seg_fn(field):
    return cuda.bind("butterfly", field, "gt_ntt_seg", 3,
                     [ctypes.c_int, ctypes.c_void_p])


def butterfly(ff: FF, y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One radix-2 DIT stage in place on y: (n, nw) contiguous words < 2p;
    tw: (half, nw) stage twiddles, n a multiple of 2 * half. Returns y,
    canonical. On the card: one gt_ntt_pass of one stage."""
    n, half = y.shape[0], tw.shape[0]
    lh = half.bit_length() - 1
    if half != 1 << lh or n % (2 * half) or y.shape[1:] != (ff.nw,) or \
            tw.shape[1:] != (ff.nw,):
        raise ValueError(f"butterfly: bad shapes y {tuple(y.shape)}, "
                         f"tw {tuple(tw.shape)}")
    if y.device.type == "cpu":
        return butterfly_plain(ff, y, tw)
    consts = cuda.field_consts(ff.p.name)
    if cuda.dev_words(y, "butterfly y") is not y:
        raise ValueError("butterfly: y must be contiguous and 16-byte "
                         "aligned (it is updated in place)")
    tw = cuda.dev_words(tw, "butterfly tw")
    fn = _pass_fn(ff.p.name)
    rc = fn(y.data_ptr(), tw.data_ptr(), n, lh, 1, half, consts.ctypes.data,
            cuda.stream(y))
    cuda.check(rc, "butterfly")
    butterfly.launches += 1
    return y


butterfly.launches = 0


def _stage(tw: torch.Tensor, s: int) -> torch.Tensor:
    """Stage s's rows of the end-to-end twiddle table."""
    return tw[(1 << (s - 1)) - 1:(1 << s) - 1]


def radix2_ntt_plain(ff: FF, x: torch.Tensor, tw: torch.Tensor):
    """Plain version of radix2_ntt: the bit-reverse gather, then
    butterfly_plain over every stage."""
    n = x.shape[0]
    y = x.index_select(0, torch.as_tensor(bitrev(n), device=x.device))
    for s in range(1, n.bit_length()):
        butterfly_plain(ff, y, _stage(tw, s))
    return y


def radix2_ntt(ff: FF, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """DFT of x in natural order: x (n, nw) words < 2p, n = 2^k >= 2; tw
    (n - 1, nw): the stage twiddles (stage_twiddles) end to end. Returns
    a new (n, nw) tensor, canonical; x is not written."""
    n = x.shape[0]
    k = n.bit_length() - 1
    if n < 2 or n != 1 << k or x.shape[1:] != (ff.nw,) or \
            tuple(tw.shape) != (n - 1, ff.nw):
        raise ValueError(f"radix2_ntt: bad shapes x {tuple(x.shape)}, "
                         f"tw {tuple(tw.shape)}")
    if x.device.type == "cpu":
        return radix2_ntt_plain(ff, x, tw)
    return _ntt_card(ff, x, tw)


def _ntt_card(ff, x, tw):
    n = x.shape[0]
    k = n.bit_length() - 1
    consts = cuda.field_consts(ff.p.name)
    x = cuda.dev_words(x, "radix2_ntt x")
    tw = cuda.dev_words(tw, "radix2_ntt tw")
    y = torch.empty_like(x)
    st = cuda.stream(x)
    seg, pas = _seg_fn(ff.p.name), _pass_fn(ff.p.name)
    cuda.check(seg(x.data_ptr(), y.data_ptr(), tw.data_ptr(), k,
                   consts.ctypes.data, st), "radix2_ntt seg")
    radix2_ntt.launches += 1
    s0 = min(k, SEG_LOG)
    while s0 < k:
        r = min(PASS_MAX, k - s0)
        cuda.check(pas(y.data_ptr(), tw.data_ptr(), n, s0, r, 1,
                       consts.ctypes.data, st), "radix2_ntt pass")
        radix2_ntt.launches += 1
        s0 += r
    return y


radix2_ntt.launches = 0


class Radix2:
    """Precomputed radix-2 plan for one (field, n, omega) triple."""

    def __init__(self, ff: FF, n: int, w: int, device):
        self.ff = ff
        self.n = n
        self.tw = torch.as_tensor(np.concatenate(stage_twiddles(ff, n, w)),
                                  device=device)

    def __call__(self, x: torch.Tensor, pre=None, post=None) -> torch.Tensor:
        """x: (n, nw) words -> DFT in natural order, canonical. pre: (n,
        nw) words multiplied into x first; post: (n, nw) or (1, nw) words
        multiplied into the result; each a K1 launch."""
        if pre is not None:
            x = mont_mul(self.ff, x, pre)
        y = radix2_ntt(self.ff, x, self.tw)
        return y if post is None else mont_mul(self.ff, y, post)
