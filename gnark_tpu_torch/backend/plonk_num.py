"""K14: the PLONK quotient's numerator over one set of evaluation points
in one launch (csrc/plonk_num.cu).

For the rows' points x (the 4N coset, or one of the rho path's N-point
shifts) and the columns evaluated there, prove.go:1040-1106's

  (gate + alpha ordering + alpha^2 L1(x) (z - 1)) / Z_H(x)

as canonical (n, nw) words. The reference computes it as one XLA
expression (gnark_tpu/backend/plonk_device.py:327 _numerator_t), around
no Pallas kernel; numerator_plain is that expression step by step, and
with kernels=True on CUDA tensors it is the 22 K1, 21 K10 and one K11
launches the kernel replaced. The terms that depend on the points alone
(x, Z_H(x), 1 / Z_H(x), Z_H(x) / (x - 1)) come from NumPoints, made once
a domain and shift; the kernel takes x as c w[i] (c a host int), so x is
never formed, and the challenges as host ints. On a CPU tensor the
wrapper runs numerator_plain; on a CUDA tensor the kernel, or an error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import ops
from gnark_tpu_torch.ff.mont import FF
from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain

# the columns the numerator reads, in the kernel's order (csrc/plonk_num.cu
# NumCols, then NumPoints.w and the Z_H(x) / (x - 1) column)
NUM_COLS = ("l", "r", "o", "z", "zs", "ql", "qr", "qm", "qo", "qk", "s1",
            "s2", "s3")
MAX_PERIOD = 8            # entries of the 1 / Z_H table at most (GT_NUM_MAXP)


def _enc(ff: FF, vals, device) -> torch.Tensor:
    return torch.as_tensor(ff.encode_words(vals), device=device)


_ZDIV: dict = {}          # NumPoints.key -> its Z_H(x) / (x - 1) column


@dataclasses.dataclass
class NumPoints:
    """The numerator's points x[i] = c w[i] (w (n, nw) words, c a host
    int) and Z_H(x), 1 / Z_H(x) as tables of `period` host ints (row i
    takes entry i % period). `key` names the points (field, domain,
    shift, device): their Z_H(x) / (x - 1) column is made on first use
    and kept under it."""
    w: torch.Tensor
    c: int
    zh: tuple
    zhi: tuple
    key: tuple

    @property
    def period(self) -> int:
        return len(self.zh)

    def x(self, ff: FF) -> torch.Tensor:
        """x as words (one K1 launch on the card unless c is 1)."""
        if self.c == 1:
            return self.w
        return mont_mul(ff, self.w, _enc(ff, [self.c], self.w.device))

    def table(self, ff: FF, vals):
        """A table as numerator_plain takes it: a host int if the period
        is 1, else the (n, nw) column of entry i % period."""
        if len(vals) == 1:
            return vals[0]
        idx = torch.arange(self.w.shape[0], device=self.w.device) % len(vals)
        return _enc(ff, vals, self.w.device)[idx]

    def zdiv(self, ff: FF) -> torch.Tensor:
        """Z_H(x) / (x - 1), canonical (n, nw) words: on first use K1 (x),
        K10, K11 and K1 on the card; then the kept column."""
        if self.key not in _ZDIV:
            dev = self.w.device
            inv = ops.batch_inv(ff, ops.sub(ff, self.x(ff),
                                            _enc(ff, [1], dev)))
            zh = self.table(ff, self.zh)
            _ZDIV[self.key] = mont_mul(
                ff, inv, _enc(ff, [zh], dev) if isinstance(zh, int) else zh)
        return _ZDIV[self.key]


def numerator_plain(ff: FF, cols, xd, zh, zhi, s, kernels=False):
    """The numerator step by step (prove.go:1040-1106): gate + alpha
    ordering + alpha^2 L1 (z - 1), times 1 / Z_H. cols: NUM_COLS -> (n,
    nw) words; xd: the points x, (n, nw) words; zh, zhi: (n, nw) words
    or host ints (constant); s: host ints beta, gamma, alpha, alpha2, u,
    u2, Ninv. Every step's plain version whatever the device; with
    kernels=True the wrappers instead (on CUDA tensors 22 K1, 21 K10 and
    one K11 launch)."""
    q = ff.p.modulus
    dev = xd.device
    if kernels:
        mm, ad, sb, inv = mont_mul, ops.add, ops.sub, ops.batch_inv
    else:
        mm, ad, sb, inv = (mont_mul_plain, ops.add_plain, ops.sub_plain,
                           ops.batch_inv_plain)

    def mul(a, b):
        return mm(ff, a, _enc(ff, [b], dev) if isinstance(b, int) else b)

    def add(a, b):
        return ad(ff, a, b)

    def sub(a, b):
        return sb(ff, a, b)

    one = _enc(ff, [1], dev)
    gamma = _enc(ff, [s["gamma"]], dev)
    l, r, o = cols["l"], cols["r"], cols["o"]
    gate = add(mul(cols["ql"], l), mul(cols["qr"], r))
    gate = add(gate, mul(cols["qm"], mul(l, r)))
    gate = add(gate, mul(cols["qo"], o))
    gate = add(gate, cols["qk"])
    bx = mul(xd, s["beta"])
    idp = add(add(l, bx), gamma)
    idp = mul(idp, add(add(r, mul(bx, s["u"])), gamma))
    idp = mul(idp, add(add(o, mul(bx, s["u2"])), gamma))
    sp = add(add(l, mul(cols["s1"], s["beta"])), gamma)
    sp = mul(sp, add(add(r, mul(cols["s2"], s["beta"])), gamma))
    sp = mul(sp, add(add(o, mul(cols["s3"], s["beta"])), gamma))
    ordering = sub(mul(sp, cols["zs"]), mul(idp, cols["z"]))
    xm1_inv = inv(ff, sub(xd, one))
    zn = zh * s["Ninv"] % q if isinstance(zh, int) else mul(zh, s["Ninv"])
    local = mul(mul(xm1_inv, zn), sub(cols["z"], one))
    numd = add(gate, mul(ordering, s["alpha"]))
    numd = add(numd, mul(local, s["alpha2"]))
    return mul(numd, zhi)


def _check(ff: FF, cols, pts: NumPoints):
    n = pts.w.shape[0]
    if not 1 <= pts.period <= MAX_PERIOD or len(pts.zhi) != pts.period:
        raise ValueError(f"plonk_numerator: Z_H tables of {len(pts.zh)} and "
                         f"{len(pts.zhi)} entries (1 to {MAX_PERIOD}, equal)")
    for k in NUM_COLS + ("w",):
        t = pts.w if k == "w" else cols.get(k)
        if t is None:
            raise ValueError(f"plonk_numerator: no column {k}")
        if tuple(t.shape) != (n, ff.nw) or n == 0:
            raise ValueError(f"plonk_numerator: {k} has shape "
                             f"{tuple(t.shape)}, not ({n} >= 1, {ff.nw})")
        if t.dtype != torch.int32:
            raise ValueError(f"plonk_numerator: {k} is {t.dtype}, not int32")
        if t.device != pts.w.device:
            raise ValueError("plonk_numerator: operands on different "
                             "devices")


@functools.lru_cache(maxsize=None)
def _fn(field):
    return cuda.bind("plonk_num", field, "gt_plonk_numerator", 3,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def plonk_numerator(ff: FF, cols, pts: NumPoints, s) -> torch.Tensor:
    """K14: the numerator at pts (NumPoints of n rows) from cols (NUM_COLS
    -> (n, nw) int32 words, inputs < 2p) and the host ints of s (beta,
    gamma, alpha, alpha2, u, u2, Ninv): canonical (n, nw) words. One
    kernel on the card (after the first call at these points, which also
    makes their Z_H(x) / (x - 1) column)."""
    _check(ff, cols, pts)
    if pts.w.device.type == "cpu":
        return numerator_plain(ff, cols, pts.x(ff), pts.table(ff, pts.zh),
                               pts.table(ff, pts.zhi), s)
    out = _numerator_card(ff, cols, pts, s)
    plonk_numerator.launches += 1
    return out


plonk_numerator.launches = 0


def _numerator_card(ff: FF, cols, pts: NumPoints, s):
    ts = [cuda.dev_words(cols[k], "plonk_numerator") for k in NUM_COLS]
    ts += [cuda.dev_words(t, "plonk_numerator")
           for t in (pts.w, pts.zdiv(ff))]
    bc = s["beta"] * pts.c
    consts = ff.encode_words([s["gamma"], s["beta"], bc, bc * s["u"],
                              bc * s["u2"], s["alpha"],
                              s["alpha2"] * s["Ninv"], *pts.zhi])
    ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    out = torch.empty_like(ts[0])
    fn = _fn(ff.p.name)
    rc = fn(ctypes.addressof(ptrs), out.data_ptr(), consts.ctypes.data,
            out.shape[0], pts.period,
            cuda.field_consts(ff.p.name).ctypes.data, cuda.stream(out))
    cuda.check(rc, "plonk_numerator")
    return out
