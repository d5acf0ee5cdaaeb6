"""Montgomery field arithmetic in PyTorch over 16-bit limbs held in int64.

Counterpart of gnark_tpu.ff.mont.FF. Two representations meet here:

  * limbs: (..., n) int64, n = ceil(bits / 16), little-endian 16-bit
    limbs. PyTorch on the CPU has no unsigned 32-bit `+`, `>>` or `<`, so
    the plain arithmetic below runs on signed 64-bit lanes, where a
    16 x 16-bit product and a few dozen of them summed fit without
    splitting. Values compare 1:1 with the reference's uint32 limb arrays.
  * words: (..., n / 2) int32, each word the bit pattern of two limbs
    (limb 2i low, limb 2i + 1 high). This is the format of the CUDA
    kernels (csrc/) and of every large tensor kept on the card. R =
    2^(16 n) is the same for both, so Montgomery values are bit-identical.

The ring ops here are the plain versions: the CPU path, the tests and
the few small host-side conversions use them. Bulk products on the card
go through ff.mont_mul (kernel K1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnark_tpu_torch.fields import FIELDS, LIMB_BITS, LIMB_MASK, FieldParams

_I64 = torch.int64


class FF:
    """Field arithmetic over (..., nlimbs) int64 limb tensors.

    Normalized representation: every limb < 2^16, value < modulus,
    Montgomery form (x*R mod p) unless a function says otherwise.
    """

    def __init__(self, params: FieldParams):
        self.p = params
        self.n = params.nlimbs
        self.nw = (self.n + 1) // 2          # 32-bit words per element
        self.P_np = np.array(params.to_limbs(params.modulus), dtype=np.int64)
        self.n0inv = params.n0inv
        self.one_np = np.array(params.to_limbs(params.R_mod), dtype=np.int64)
        self.R2_np = np.array(params.to_limbs(params.R2_mod), dtype=np.int64)
        # -p^-1 mod R, the whole-width REDC constant (_mul_wide)
        self.NP_np = np.array(params.to_limbs(
            -pow(params.modulus, -1, params.R) % params.R), dtype=np.int64)
        e = params.modulus - 2
        self.pm2_bits = [(e >> i) & 1 for i in range(params.bits)]
        # 4p >= R (bls12_381_fr: 4r ~ 1.81 R): a product of two inputs
        # < 2p reaches (4p^2 + R p) / R, past 2p, so it takes a second
        # conditional subtract (csrc/mont.cuh's sound class)
        self.sound = 4 * params.modulus >= params.R
        self._dev: dict = {}

    def _const(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name), device=device)
            self._dev[key] = t
        return t

    # ------------------------------------------------------------------
    # host <-> tensor
    # ------------------------------------------------------------------

    def _ints(self, values, mont: bool):
        arr = np.asarray(values, dtype=object)
        q = self.p.modulus
        rm = self.p.R_mod
        if mont:
            ints = [int(v) * rm % q for v in arr.reshape(-1)]
        else:
            ints = [int(v) % q for v in arr.reshape(-1)]
        return arr.shape, ints

    def encode(self, values, mont: bool = True) -> np.ndarray:
        """Python ints (nested lists / flat) -> (..., n) int64 limbs."""
        shape, ints = self._ints(values, mont)
        nb = 2 * self.n
        buf = b"".join(x.to_bytes(nb, "little") for x in ints)
        out = np.frombuffer(buf, dtype="<u2").astype(np.int64)
        return out.reshape(shape + (self.n,))

    def encode_words(self, values, mont: bool = True) -> np.ndarray:
        """Python ints -> (..., nw) int32 words (the kernels' format)."""
        shape, ints = self._ints(values, mont)
        nb = 4 * self.nw
        buf = b"".join(x.to_bytes(nb, "little") for x in ints)
        out = np.frombuffer(buf, dtype="<i4").copy()
        return out.reshape(shape + (self.nw,))

    def decode(self, limbs, mont: bool = True):
        """(..., n) limbs -> numpy object array of Python ints."""
        arr = _np(limbs).astype(np.int64)
        shape = arr.shape[:-1]
        raw = np.ascontiguousarray(arr.reshape(-1, self.n).astype("<u2"))
        return self._from_bytes(raw.tobytes(), 2 * self.n, shape, mont)

    def decode_words(self, words, mont: bool = True):
        """(..., nw) int32 words -> numpy object array of Python ints."""
        arr = np.ascontiguousarray(_np(words).astype("<i4"))
        shape = arr.shape[:-1]
        return self._from_bytes(arr.tobytes(), 4 * self.nw, shape, mont)

    def _from_bytes(self, b: bytes, w: int, shape, mont: bool):
        q = self.p.modulus
        rinv = pow(self.p.R, -1, q)
        cnt = len(b) // w
        out = np.empty(cnt, dtype=object)
        for i in range(cnt):
            x = int.from_bytes(b[w * i:w * i + w], "little")
            out[i] = x * rinv % q if mont else x
        return out.reshape(shape) if shape else out[0]

    # ------------------------------------------------------------------
    # limbs <-> words
    # ------------------------------------------------------------------

    def to_words(self, limbs: torch.Tensor) -> torch.Tensor:
        """(..., n) normalized int64 limbs -> (..., nw) int32 words."""
        if self.n % 2:
            limbs = torch.cat([limbs, torch.zeros_like(limbs[..., :1])], -1)
        w = limbs[..., 0::2] | (limbs[..., 1::2] << LIMB_BITS)
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    def from_words(self, words: torch.Tensor) -> torch.Tensor:
        """(..., nw) int32 words -> (..., n) int64 limbs."""
        return self.limbs_from_u32(words)

    def limbs_from_u32(self, w: torch.Tensor) -> torch.Tensor:
        """(..., k) 32-bit words (int32 bit patterns, e.g. the
        little-endian view of u64 limbs) -> (..., n) 16-bit limbs,
        truncated or zero-padded to n."""
        w64 = w.to(_I64) & 0xFFFFFFFF
        inter = torch.stack([w64 & LIMB_MASK, w64 >> LIMB_BITS], dim=-1)
        inter = inter.reshape(w.shape[:-1] + (2 * w.shape[-1],))
        if inter.shape[-1] >= self.n:
            return inter[..., :self.n]
        pad = torch.zeros(w.shape[:-1] + (self.n - inter.shape[-1],),
                          dtype=_I64, device=w.device)
        return torch.cat([inter, pad], -1)

    @staticmethod
    def u64_view(arr_u64) -> np.ndarray:
        """Host zero-copy view: (..., nl) u64 -> (..., 2*nl) u32."""
        a = np.ascontiguousarray(np.asarray(arr_u64, dtype=np.uint64))
        return a.view(np.uint32).reshape(a.shape[:-1] + (a.shape[-1] * 2,))

    def zeros(self, shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.n,), dtype=_I64,
                           device=device)

    def ones(self, shape=(), device="cpu") -> torch.Tensor:
        return self._const("one_np", device).expand(
            tuple(shape) + (self.n,))

    # ------------------------------------------------------------------
    # limb helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _lookahead(lo, gen, prop):
        """Resolve 0/1 carries without a ripple: the carry out of limb i
        is gen_i, or prop_i and the carry into limb i. Returns (carry
        into each limb, carry out of the top limb), int64."""
        pos = torch.arange(lo.shape[-1], device=lo.device).expand(lo.shape)
        last = torch.where(prop, -1, pos).cummax(-1).values
        c_out = torch.where(last >= 0, gen.gather(-1, last.clamp(min=0)), 0)
        c_in = torch.nn.functional.pad(c_out[..., :-1], (1, 0))
        return c_in, c_out[..., -1]

    def _norm_add(self, s):
        """Limbs in [0, 2^17 - 1) -> (normalized limbs, carry out)."""
        lo = s & LIMB_MASK
        c_in, c = self._lookahead(lo, s >> LIMB_BITS, lo == LIMB_MASK)
        return (lo + c_in) & LIMB_MASK, c

    def _norm_sub(self, d):
        """Limbs in (-2^16, 2^16) -> (normalized limbs, borrow out)."""
        lo = d & LIMB_MASK
        c_in, c = self._lookahead(lo, (d < 0).to(_I64), d == 0)
        return (lo - c_in) & LIMB_MASK, c

    def _normalize(self, x, rounds: int = 3):
        """Nonnegative limbs below 2^48 whose value fits the width ->
        normalized limbs: three carry-save rounds leave every limb at
        most 2^16 + 1, then one lookahead resolves the 0/1 carries (two
        rounds do for limbs below 2^38). A value past the width comes
        back mod 2^(16 width)."""
        for _ in range(rounds):
            x = (x & LIMB_MASK) + torch.nn.functional.pad(
                x[..., :-1] >> LIMB_BITS, (1, 0))
        return self._norm_add(x)[0]

    def _sub_if_ge(self, a, top, col_np: str):
        """top*2^(16n) + a minus the constant if that is >= it."""
        d, borrow = self._norm_sub(a - self._const(col_np, a.device))
        return torch.where((top >= borrow)[..., None], d, a)

    def _cond_sub(self, a, col_np: str = "P_np"):
        """Subtract the constant once if a >= it (a of width n or n+1)."""
        top = a[..., self.n] if a.shape[-1] > self.n else \
            torch.zeros_like(a[..., 0])
        return self._sub_if_ge(a[..., :self.n], top, col_np)

    def canon(self, a):
        """Any representative < 3p -> canonical [0, p)."""
        return self._cond_sub(self._cond_sub(a))

    # ------------------------------------------------------------------
    # ring ops
    # ------------------------------------------------------------------

    def add(self, a, b):
        s, c = self._norm_add(a + b)
        return self._sub_if_ge(s, c, "P_np")

    def sub(self, a, b):
        d, borrow = self._norm_sub(a - b)
        s, _ = self._norm_add(d + self._const("P_np", a.device))
        return torch.where(borrow[..., None] != 0, s, d)

    def neg(self, a):
        d, _ = self._norm_sub(self._const("P_np", a.device) - a)
        return torch.where(self.is_zero(a)[..., None], a, d)

    def _diag(self, device) -> torch.Tensor:
        """(n*n, 2n) 0/1 float64 matrix summing an outer product's
        anti-diagonals: outer.reshape(n*n) @ D = schoolbook product."""
        key = ("_diag", str(device))
        D = self._dev.get(key)
        if D is None:
            n = self.n
            D = torch.zeros(n * n, 2 * n, dtype=torch.float64)
            for i in range(n):
                for j in range(n):
                    D[i * n + j, i + j] = 1.0
            D = self._dev[key] = D.to(device)
        return D

    def _schoolbook(self, a, b, cols: int):
        """The first cols limbs of the schoolbook product of normalized
        limbs a and b, unnormalized: one matrix product (float64 is exact
        here: each anti-diagonal sum is below n * 2^32)."""
        n = self.n
        batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        af, bf = a.to(torch.float64), b.to(torch.float64)
        return ((af[..., :, None] * bf[..., None, :]).reshape(batch + (n * n,))
                @ self._diag(a.device)[:, :cols]).to(_I64)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p. Inputs < 2p with
        normalized limbs; output canonical (with 4p >= R after two
        conditional subtracts, else one).

        Separated operand scanning: the schoolbook product T (2n limbs)
        in one matrix product, then n reduction steps over the
        limb-major (2n + 1, batch) layout, each adding m*p at limb i so
        that limb i becomes 0 mod 2^16 and carrying it up. On the card,
        where each of those steps' six launches costs more than its
        work, _mul_wide: the same value in a fixed ~90 launches."""
        a, b = torch.broadcast_tensors(a, b)
        if a.device.type == "cuda":
            return self._mul_wide(a, b)
        n = self.n
        batch = a.shape[:-1]
        P = self._const("P_np", a.device)[:, None]
        T = self._schoolbook(a, b, 2 * n)
        T = torch.nn.functional.pad(T.reshape(-1, 2 * n).T,
                                    (0, 0, 0, 1)).contiguous()
        for i in range(n):
            m = (T[i] * self.n0inv) & LIMB_MASK
            T[i:i + n] += P * m
            T[i + 1] += T[i] >> LIMB_BITS
        R = T[n:].T.reshape(batch + (n + 1,))
        out = self._cond_sub(self._normalize(R))
        return self._cond_sub(out) if self.sound else out

    def _mul_wide(self, a, b):
        """mul's value by whole-width REDC: m = (T mod R)(-p^-1) mod R
        and (T + m p) / R, each product one schoolbook matrix product;
        m is the one the limb steps build, so the result is the same."""
        n = self.n
        pad = torch.nn.functional.pad
        T = self._schoolbook(a, b, 2 * n)                # limbs < n 2^32
        m = self._normalize(self._schoolbook(
            self._normalize(T[..., :n], 2), self._const("NP_np", a.device),
            n), 2)
        S = pad(T, (0, 1)) + pad(self._schoolbook(
            m, self._const("P_np", a.device), 2 * n), (0, 1))
        # S = 0 mod R and S < 2 R^2: its top n + 1 limbs are (T + m p) / R
        out = self._cond_sub(self._normalize(S, 2)[..., n:])
        return self._cond_sub(out) if self.sound else out

    def square(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    def mul_small(self, a, k: int):
        """a * small-int k (k >= 0)."""
        if k == 0:
            return torch.zeros_like(a)
        r = None
        base = a
        while k:
            if k & 1:
                r = base if r is None else self.add(r, base)
            k >>= 1
            if k:
                base = self.double(base)
        return r

    def to_mont(self, a):
        return self.mul(a, self._const("R2_np", a.device))

    def from_mont(self, a):
        one = torch.zeros_like(a)
        one[..., 0] = 1
        return self.mul(a, one)

    # ------------------------------------------------------------------
    # predicates / select / inversion
    # ------------------------------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def select(self, cond, a, b):
        """cond ? a : b, cond shaped like the batch dims."""
        return torch.where(cond[..., None], a, b)

    def pow_bits(self, a, bits_lsb):
        """a ** e with e given as an LSB-first bit list."""
        r = self.ones(a.shape[:-1], a.device)
        for bit in reversed(bits_lsb):
            r = self.square(r)
            if bit:
                r = self.mul(r, a)
        return r

    def inv(self, a):
        """Batched inversion via Fermat (a^(p-2)); inv(0) = 0."""
        return self.pow_bits(a, self.pm2_bits)

    def scan_mul(self, a, reverse: bool = False):
        """Inclusive prefix (suffix, reverse=True) products along the
        first axis of an (n, n_limbs) batch: Hillis and Steele, log2(n)
        batched products; canonical out."""
        r = self.canon(a)
        n, off = a.shape[0], 1
        while off < n:
            if reverse:
                r = torch.cat([self.mul(r[:n - off], r[off:]), r[n - off:]])
            else:
                r = torch.cat([r[:off], self.mul(r[off:], r[:n - off])])
            off *= 2
        return r

    def batch_inv(self, a):
        """Montgomery batch inversion over the first axis (the
        reference's FF.batch_inv): prefix and suffix product scans and
        one Fermat inverse of the total; zeros invert to zero, as in
        gnark's BatchInvert. Below 4 rows, Fermat alone."""
        if a.dim() != 2 or a.shape[0] < 4:
            return self.inv(a)
        z = self.is_zero(self.canon(a))
        ax = self.select(z, self.ones(a.shape[:-1], a.device), a)
        pref = self.scan_mul(ax)
        suf = self.scan_mul(ax, reverse=True)
        tinv = self.inv(pref[-1:])
        one = self.ones((1,), a.device)
        pe = torch.cat([one, pref[:-1]])
        se = torch.cat([suf[1:], one])
        out = self.mul(self.mul(pe, se), tinv)
        return self.select(z, torch.zeros_like(a), out)


def on_words(f, op: str, *words):
    """Plain field op `op` of f (FF or FF2) on word tensors: words in,
    canonical words out (for the few such ops outside the kernels)."""
    return f.to_words(getattr(f, op)(*(f.from_words(w) for w in words)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def get_ff(name: str) -> FF:
    return FF(FIELDS[name])
