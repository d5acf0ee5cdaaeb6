"""Radix-2 DIT NTT over word tensors, with kernel K5 butterfly.

Counterpart of gnark_tpu.ntt.domain._ntt_kernel: a bit-reverse gather,
then log2 n stages; stage s (m = 2^s, half = m/2) maps each block of m
elements (e | o) to (e + o*tw | e - o*tw) with tw[j] = w_m^j, w_m = w^(n/m).
Each stage is one K5 launch (gnark_tpu.ff.pallas_ops.butterfly_p), in
place on the gathered copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import FF
from gnark_tpu_torch.ntt.fourstep import _powers, bitrev


def stage_twiddles(ff: FF, n: int, w: int) -> list:
    """Per-stage twiddle words, Montgomery: stage s is (2^(s-1), nw)."""
    q = ff.p.modulus
    k = n.bit_length() - 1
    return [ff.encode_words(_powers(pow(w, n >> s, q), 1 << (s - 1), q))
            for s in range(1, k + 1)]


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
def _fn():
    return cuda.bind("butterfly", "gt_butterfly", 2,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def butterfly(ff: FF, y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One radix-2 DIT stage in place on y: (n, nw) contiguous words < 2p;
    tw: (half, nw) stage twiddles, n a multiple of 2 * half. Returns y,
    canonical."""
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
    rc = _fn()(y.data_ptr(), tw.data_ptr(), n // 2, lh, consts.ctypes.data,
               cuda.stream(y))
    cuda.check(rc, "butterfly")
    butterfly.launches += 1
    return y


butterfly.launches = 0


class Radix2:
    """Precomputed radix-2 plan for one (field, n, omega) triple."""

    def __init__(self, ff: FF, n: int, w: int, device):
        self.ff = ff
        self.n = n
        self.rev = torch.as_tensor(bitrev(n), device=device)
        self.tw = [torch.as_tensor(t, device=device)
                   for t in stage_twiddles(ff, n, w)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, nw) words -> DFT in natural order, canonical."""
        y = x.index_select(0, self.rev)
        for tw in self.tw:
            butterfly(self.ff, y, tw)
        return y
