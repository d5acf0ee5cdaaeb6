"""The PLONK prover on the card.

Counterpart of gnark_tpu.backend.plonk_device (reference
backend/plonk/bn254/prove.go:98-153): every O(N) polynomial operation
(column gathers, basis changes, the Z ratio product, the quotient
numerator, the evaluations at zeta, the linearized polynomial and both
KZG opening quotients) runs on the card over (n, nw) int32 Montgomery
words; the host sequences Fiat-Shamir and handles O(1) scalars
(blinding factors, claimed values).

Kernels: K1 (ff/mont_mul) for products, K10-K13 (ff/ops: add / sub,
batch_inv, scan_mul, dot / dot_many) for the rest of the field work, K14
(backend/plonk_num) for the quotient's numerator, K5 / K2
(ntt.Domain) for the transforms, the bucket MSM (K4, K9) for the KZG
commitments. Where the reference computes an O(1) scalar on the device
(zeta^N, l1(zeta), the linearization's coefficients) the port computes
it on the host from the decoded evaluations: the same field values.

The stages of prove:
  1 L, R, O: gather from the solver's words, iFFT, blind, 3 commits
  2 Z: the permutation ratios (one batch inversion), their prefix
    product (scan_mul), iFFT, blind, commit
  3 the quotient: the columns on the 4N coset (or, at N >=
    2^RHO_MIN_LOG, on four N-point shifts: the rho path), the
    numerator (one K14 launch a set of points), the coset iFFT, three
    shards, 3 commits
  4 the evaluations at zeta (K13: one launch for the columns at zeta,
    one for z at w zeta, one for the linearized polynomial)
  5 the folded opening at zeta and Z's at omega zeta, by
    evaluate-and-divide on a 2N domain, 2 commits
"""

from __future__ import annotations

import secrets
import time

import numpy as np
import torch

from gnark_tpu_torch.backend import kzg as kzg_mod
from gnark_tpu_torch.backend.groth16 import _mark_fn, _words_u64
from gnark_tpu_torch.backend.plonk_num import NumPoints, plonk_numerator
from gnark_tpu_torch.constraint import solve_auto
from gnark_tpu_torch.cuda import check_curve, resolve_device
from gnark_tpu_torch.ff import get_ff, ops
from gnark_tpu_torch.ff.mont_mul import mont_mul
from gnark_tpu_torch.logger import get_logger
from gnark_tpu_torch.ntt import get_domain

# The quotient takes the rho path (four N-point shifts instead of the 4N
# coset) from N = 2^RHO_MIN_LOG up: the reference's default switch
# point. Both paths give the same quotient.
RHO_MIN_LOG = 18

# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def enc(ff, vals, device) -> torch.Tensor:
    """host ints -> (len, nw) Montgomery words on device."""
    q = ff.p.modulus
    return torch.as_tensor(ff.encode_words([v % q for v in vals]),
                           device=device)


def _pad(x: torch.Tensor, m: int) -> torch.Tensor:
    if x.shape[0] >= m:
        return x
    return torch.cat([x, x.new_zeros((m - x.shape[0], x.shape[1]))])


def _mul_s(ff, a, s: int):
    """a times the host scalar s (one broadcast K1 launch)."""
    return mont_mul(ff, a, enc(ff, [s], a.device))


def sparse_column(ff, n: int, rows, vals, device) -> torch.Tensor:
    """(n, nw) Montgomery words: vals at rows (a device index tensor),
    zero elsewhere."""
    col = torch.zeros((n, ff.nw), dtype=torch.int32, device=device)
    if len(vals):
        col[rows] = enc(ff, vals, device)
    return col


def dev_powers(ff, base: int, n: int, device) -> torch.Tensor:
    """[1, b, b^2, ..., b^(n-1)] as Montgomery words (K12 over
    [1, b, b, ..., b])."""
    b = enc(ff, [1, base], device)
    x = torch.cat([b[:1], b[1:].expand(n - 1, ff.nw)])
    return ops.scan_mul(ff, x)


def ff_sum(ff, a) -> torch.Tensor:
    """sum of the rows of a (n, nw) -> (1, nw) (K13 without b)."""
    return ops.dot(ff, a)


def dev_poly_eval(ff, coeffs_dev, zpows) -> int:
    """Evaluate Montgomery coefficients at z given the powers of z
    (>= len(coeffs)); one K13 launch; returns a host int."""
    n = coeffs_dev.shape[0]
    s = ops.dot(ff, coeffs_dev, zpows[:n])
    return int(ff.decode_words(s.cpu())[0])


def dev_lincomb(ff, polys, scalars):
    """sum_i scalars[i] * polys[i] over Montgomery coefficient words
    (host int scalars), zero-padded to the longest."""
    m = max(p.shape[0] for p in polys)
    acc = None
    for p, s in zip(polys, scalars):
        t = _pad(p if s == 1 else _mul_s(ff, p, s), m)
        acc = t if acc is None else ops.add(ff, acc, t)
    return acc


class _DevDomain:
    """Cached per (field, n, device): the domain and its points."""

    _cache: dict = {}

    @classmethod
    def get(cls, ff, n, device):
        key = (ff.p.name, n, str(device))
        if key not in cls._cache:
            dom = get_domain(ff, n, device)
            cls._cache[key] = (dom, dev_powers(ff, dom.omega, n, device))
        return cls._cache[key]


def open_quotient_dev(ff, dom_n2, xs, coeffs_dev, z: int, claimed: int):
    """(p(X) - p(z)) / (X - z) coefficients: p on the n2 domain minus
    the claimed value, times the batch-inverted (x_i - z), iFFT."""
    dev = xs.device
    evals = dom_n2.fft(_pad(coeffs_dev, xs.shape[0]))
    quot = mont_mul(ff, ops.sub(ff, evals, enc(ff, [claimed], dev)),
                    ops.batch_inv(ff, ops.sub(ff, xs, enc(ff, [z], dev))))
    return dom_n2.ifft(quot)


def commit_dev(srs: kzg_mod.SRS, coeffs_mont):
    """KZG commitment of Montgomery coefficient words -> host affine
    point: out of Montgomery form (K1), then the routed MSM."""
    ff = get_ff(srs.curve.fr.name)
    one = torch.as_tensor(ff.encode_words([1], mont=False),
                          device=coeffs_mont.device)
    return kzg_mod.commit_affine(srs, mont_mul(ff, coeffs_mont, one))


def ff_scale_powers(ff, coeffs_dev, w: int):
    """coeffs[i] * w^i (the Z(wX) shift)."""
    n = coeffs_dev.shape[0]
    return mont_mul(ff, coeffs_dev, dev_powers(ff, w, n, coeffs_dev.device))


def _blind(ff, c_dev, b):
    """c(X) + b(X) (X^N - 1), c of exactly N coefficients and b of
    (order + 1) rows: concat(c[:o] - b, c[o:], b)."""
    o = b.shape[0]
    return torch.cat([ops.sub(ff, c_dev[:o], b), c_dev[o:], b])


def _col_indexes(cs, N):
    """xa/xb/xc wire-index vectors for the L/R/O gather (row 0..N-1:
    nb_pub public rows then the gates; padding rows gather wire 0)."""
    cache = getattr(cs, "_plonk_col_idx", None)
    if cache is not None and cache[0].shape[0] == N:
        return cache
    nb_pub = cs.nb_public
    n = len(cs.sparse)
    xa = np.zeros(N, dtype=np.int64)
    xb = np.zeros(N, dtype=np.int64)
    xc = np.zeros(N, dtype=np.int64)
    xa[:nb_pub] = np.arange(nb_pub)
    xa[nb_pub:nb_pub + n] = np.fromiter(
        (c.xa for c in cs.sparse), dtype=np.int64, count=n)
    xb[nb_pub:nb_pub + n] = np.fromiter(
        (c.xb for c in cs.sparse), dtype=np.int64, count=n)
    xc[nb_pub:nb_pub + n] = np.fromiter(
        (c.xo for c in cs.sparse), dtype=np.int64, count=n)
    cs._plonk_col_idx = (xa, xb, xc)
    return cs._plonk_col_idx


def _inv0(x: int, q: int) -> int:
    """x^-1 mod q, 0 for 0 (the reference's Fermat inverse)."""
    return pow(x, -1, q) if x % q else 0


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _s1_lro(ff, dom, cols, blinds):
    return tuple(_blind(ff, dom.ifft(col), b)
                 for col, b in zip(cols, blinds))


def _s2_z(ff, dom, L, R, O, pk, beta: int, gamma: int, zb, u: int):
    """Z in Lagrange form from the permutation ratios, iFFT'd and
    blinded (prove.go:635 BuildRatioCopyConstraint)."""
    q = ff.p.modulus
    N = L.shape[0]
    dev = L.device
    g = enc(ff, [gamma], dev)
    bx = _mul_s(ff, pk.wpow, beta)
    nm = ops.add(ff, ops.add(ff, L, bx), g)
    nm = mont_mul(ff, nm, ops.add(ff, ops.add(ff, R, _mul_s(ff, bx, u)), g))
    nm = mont_mul(ff, nm, ops.add(ff, ops.add(
        ff, O, _mul_s(ff, bx, u * u % q)), g))
    dn = ops.add(ff, ops.add(ff, L, _mul_s(ff, pk.s1_vals, beta)), g)
    dn = mont_mul(ff, dn, ops.add(ff, ops.add(
        ff, R, _mul_s(ff, pk.s2_vals, beta)), g))
    dn = mont_mul(ff, dn, ops.add(ff, ops.add(
        ff, O, _mul_s(ff, pk.s3_vals, beta)), g))
    scan = ops.scan_mul(ff, mont_mul(ff, nm, ops.batch_inv(ff, dn)))
    z_lag = torch.cat([enc(ff, [1], dev), scan[:N - 1]])
    return _blind(ff, dom.ifft(z_lag), zb)


def _numerator(ff, cols, pts, s):
    """The quotient's numerator over one set of evaluation points
    (prove.go:1040-1106): gate + alpha ordering + alpha^2 L1 (Z - 1),
    times 1 / Z_H. pts: plonk_num.NumPoints. One K14 launch on the card;
    the plain step-by-step composition on the CPU."""
    return plonk_numerator(ff, cols, pts, s)


def _coset_points(ff, N4: int, period: int, device):
    """The 4N coset's points x = g w4^i (a kept column) with their Z_H(x)
    and 1 / Z_H(x) (period `period`)."""
    key = ("coset", ff.p.name, N4, period, str(device))
    if key not in _COSET:
        q = ff.p.modulus
        dom4 = get_domain(ff, N4, device)
        g = ff.p.generator % q
        gN = pow(g, N4 // period, q)
        w4N = pow(dom4.omega, N4 // period, q)
        zh_vals = [(gN * pow(w4N, i, q) - 1) % q for i in range(period)]
        xd = _mul_s(ff, dev_powers(ff, dom4.omega, N4, device), g)
        _COSET[key] = NumPoints(xd, 1, tuple(zh_vals),
                                tuple(pow(v, -1, q) for v in zh_vals), key)
    return _COSET[key]


_COSET: dict = {}


def _shift_points(ff, wpow, N: int, shift: int):
    """The rho path's points x = shift w^i (wpow: the N powers of w) with
    their constant Z_H(x) = shift^N - 1 and its inverse."""
    q = ff.p.modulus
    zh = (pow(shift, N, q) - 1) % q
    return NumPoints(wpow, shift, (zh,), (pow(zh, -1, q),),
                     ("shift", ff.p.name, N, shift, str(wpow.device)))


def _on_coset(dom4, c):
    return dom4.fft(_pad(c, dom4.n), coset=True)


def _s3_quotient(ff, dom4, cols, qkc, qcps, pi2s, scal, period: int):
    """The quotient's evaluations on the 4N coset -> its coefficients."""
    ev = {k: _on_coset(dom4, v) for k, v in cols.items()}
    qkx = _on_coset(dom4, qkc)
    for qcp_c, pi2_c in zip(qcps, pi2s):
        qkx = ops.add(ff, qkx, mont_mul(ff, _on_coset(dom4, qcp_c),
                                        _on_coset(dom4, pi2_c)))
    ev["qk"] = qkx
    pts = _coset_points(ff, dom4.n, period, qkc.device)
    return dom4.ifft(_numerator(ff, ev, pts, scal), coset=True)


def _rho_quotient(ff, dom, dom4, cols, qkc, pk, pi2s, period, N, scal):
    """The rho path (computeNumerator, prove.go:936-1020): the numerator
    on the N-point shifts g w4^s, s < period, one at a time, interleaved
    into the 4N coset order, then one coset iFFT."""
    q = ff.p.modulus
    dev = qkc.device
    g = ff.p.generator % q
    w4 = dom4.omega
    chunks = []
    for sshift in range(period):
        shift = g * pow(w4, sshift, q) % q
        cN = pow(shift, N, q)
        spows = dev_powers(ff, shift, N, dev)

        def eval_shift(c):
            blocks = -(-c.shape[0] // N)
            c = _pad(c, blocks * N)
            acc, cp = c[:N], 1
            for b in range(1, blocks):
                cp = cp * cN % q
                acc = ops.add(ff, acc, _mul_s(ff, c[b * N:(b + 1) * N], cp))
            return dom.fft(mont_mul(ff, acc, spows))

        ev = {k: eval_shift(v) for k, v in cols.items()}
        qkx = eval_shift(qkc)
        for qcp_c, pi2_c in zip(pk.qcp_coeffs, pi2s):
            qkx = ops.add(ff, qkx, mont_mul(ff, eval_shift(qcp_c),
                                            eval_shift(pi2_c)))
        ev["qk"] = qkx
        chunks.append(_numerator(ff, ev, _shift_points(ff, pk.wpow, N,
                                                       shift), scal))
    inter = torch.stack(chunks, dim=1).reshape(period * N, ff.nw)
    return dom4.ifft(inter, coset=True)


def _s4_evals(ff, polys, zeta, N, w, Ninv, beta, gamma, alpha, u, device):
    """The claimed evaluations (three K13 launches: l, r, o, s1, s2 and
    the qcps at zeta in one, z at w zeta, the linearized polynomial at
    zeta) and the linearized polynomial. Returns (claimed ints, lin
    words, zu)."""
    q = ff.p.modulus
    maxlen = max(p.shape[0] for p in (polys["l"], polys["h0"], polys["z"]))
    zpows = dev_powers(ff, zeta, maxlen, device)

    at_zeta = ops.dot_many(ff, [polys[k] for k in ("l", "r", "o", "s1",
                                                   "s2")]
                           + list(polys["qcps"]), zpows)
    lz, rz, oz, s1z, s2z, *qcpz = (int(v) for v in
                                   ff.decode_words(at_zeta.cpu()))
    zu = dev_poly_eval(ff, polys["z"], dev_powers(
        ff, w * zeta % q, polys["z"].shape[0], device))

    zh_zeta = (pow(zeta, N, q) - 1) % q
    l1_zeta = zh_zeta * _inv0(zeta - 1, q) % q * Ninv % q
    a2l1 = alpha * alpha % q * l1_zeta % q
    t1 = (lz + beta * s1z + gamma) % q
    t2 = (rz + beta * s2z + gamma) % q
    s1c = alpha * beta % q * (t1 * t2 % q) % q * zu % q
    bz = beta * zeta % q
    idp = (lz + bz + gamma) % q
    idp = idp * ((rz + u * bz + gamma) % q) % q
    idp = idp * ((oz + u * u % q * bz + gamma) % q) % q
    coeff_z = (a2l1 - alpha * idp) % q
    zp2 = pow(zeta, N + 2, q)
    zh = (q - zh_zeta) % q
    zhp = zh * zp2 % q
    lin = dev_lincomb(
        ff, [polys["ql"], polys["qr"], polys["qm"], polys["qo"],
             polys["qk"]] + list(polys["pi2s"])
        + [polys["s3"], polys["z"], polys["h0"], polys["h1"], polys["h2"]],
        [lz, rz, lz * rz % q, oz, 1] + qcpz
        + [s1c, coeff_z, zh, zhp, zhp * zp2 % q])
    claimed = [dev_poly_eval(ff, lin, zpows), lz, rz, oz, s1z, s2z] + qcpz
    return claimed, lin, zu


def _s5_open(ff, dom2, xs2, open_polys, fold_scals, zeta, fclaim, z_b,
             wz, zu):
    """The folded polynomial's and Z's opening quotients."""
    folded = dev_lincomb(ff, open_polys, fold_scals)
    bq = open_quotient_dev(ff, dom2, xs2, folded, zeta, fclaim)
    zq = open_quotient_dev(ff, dom2, xs2, z_b, wz, zu)
    return bq[:folded.shape[0]], zq[:z_b.shape[0]]


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------

def prove(cs, pk, public, secret, rng=None, hint_overrides=None,
          recursion_friendly=False, statistical_zk: bool = False,
          challenge_hash=None, timings: dict | None = None, device=None):
    """See backend/plonk.py prove. timings: seconds per stage (solve,
    upload, lro, z, quotient, evals, open: groth16._mark_fn's host clock,
    the card synchronized at each mark; commit: the KZG commitments'
    share of the stages; bsb22: the commitment hint's, inside solve)."""
    from gnark_tpu_torch.backend import plonk as P

    vk = pk.vk
    curve = vk.curve
    q = curve.fr.modulus
    N = vk.size
    w = vk.generator
    u = vk.coset_shift
    dev = resolve_device(device)
    check_curve(curve, dev, plonk=True)
    if pk.device != dev:
        raise ValueError(f"the proving key is on {pk.device}, not {dev}")
    rnd = rng.randrange if rng is not None else \
        (lambda n: secrets.randbelow(n))
    nb_pub = cs.nb_public
    ffr = get_ff(curve.fr.name)
    dom = get_domain(ffr, N, dev)
    mark = _mark_fn(timings, dev, get_logger("gnark_tpu_torch"),
                    "plonk prove")

    def commit(c):
        t = time.perf_counter()
        pt = commit_dev(pk.srs, c)
        if timings is not None:
            timings["commit"] = timings.get("commit", 0.0) + \
                time.perf_counter() - t
        return pt

    # --- BSB22 commit hint (prove.go:268-311) ------------------------------
    bsb22_pts: list = []
    bsb22_vals: list = []
    pi2_dev: list = []         # pi2 canonical coefficients

    def _bsb22_prove_hint(q_, ins):
        t = time.perf_counter()
        cm = cs.commitments[len(bsb22_pts)]
        rows = [nb_pub + row for row in cm.committed_rows]
        vals = [v % q for v in ins]
        rows += [nb_pub + cm.commitment_row, nb_pub + cs.nb_constraints - 1]
        vals += [rnd(q), rnd(q)]
        # a later row's value replaces an earlier one, as in the host list
        last = dict(zip(rows, vals))
        c_dev = dom.ifft(sparse_column(
            ffr, N, torch.as_tensor(list(last), device=dev),
            list(last.values()), dev))
        pt = commit(c_dev)
        val = P._h2f_bsb22(curve, pt, recursion_friendly)
        bsb22_pts.append(pt)
        bsb22_vals.append(val)
        pi2_dev.append(c_dev)
        if timings is not None:
            timings["bsb22"] = timings.get("bsb22", 0.0) + \
                time.perf_counter() - t
        return [val]

    overrides = dict(hint_overrides or {})
    if cs.commitments:
        overrides["bsb22"] = _bsb22_prove_hint

    sol = solve_auto(cs, public, secret, hint_overrides=overrides)
    mark("solve")
    publics = sol.values[:nb_pub]

    # --- L, R, O device columns (solver.go:150-170 layout) -----------------
    vals_u64 = getattr(sol, "values_u64", None)
    if vals_u64 is None:
        nl = (curve.fr.bits + 63) // 64
        m64 = (1 << 64) - 1
        vals_u64 = np.array([[(v >> (64 * i)) & m64 for i in range(nl)]
                             for v in sol.values], dtype=np.uint64)
    wires = _words_u64(vals_u64, dev)
    idx = torch.as_tensor(np.concatenate(_col_indexes(cs, N)), device=dev)
    r2 = torch.as_tensor(ffr.encode_words([ffr.p.R2_mod], mont=False),
                         device=dev)
    L, R, O = mont_mul(ffr, wires[idx], r2).split(N)

    # complete qk: public inputs + commitment challenges (completeQk)
    qk_rows = list(range(nb_pub)) + \
        [nb_pub + cm.commitment_row for cm in cs.commitments]
    qk = pk.qk.clone()
    qk[torch.as_tensor(qk_rows, device=dev)] = enc(
        ffr, list(publics) + bsb22_vals, dev)
    qkc_dev = dom.ifft(qk)
    mark("upload")

    # --- stage 1: columns + commits ----------------------------------------
    blinds = [enc(ffr, [rnd(q), rnd(q)], dev) for _ in range(3)]
    l_b, r_b, o_b = _s1_lro(ffr, dom, (L, R, O), blinds)
    c_l, c_r, c_o = (commit(c) for c in (l_b, r_b, o_b))
    mark("lro")

    # --- gamma, beta --------------------------------------------------------
    ts = P._new_transcript(vk, recursion_friendly, challenge_hash)
    P._bind_public_data(ts, vk, publics)
    p_mod = curve.fp.modulus
    for pt in (c_l, c_r, c_o):
        ts.bind("gamma", ts.point_bytes(pt, p_mod))
    gamma = ts.challenge("gamma")
    beta = ts.challenge("beta")

    # --- stage 2: Z ----------------------------------------------------------
    zb = enc(ffr, [rnd(q), rnd(q), rnd(q)], dev)      # order 2
    z_b = _s2_z(ffr, dom, L, R, O, pk, beta, gamma, zb, u)
    c_z = commit(z_b)
    mark("z")

    for pt in bsb22_pts:
        ts.bind("alpha", ts.point_bytes(pt, p_mod))
    ts.bind("alpha", ts.point_bytes(c_z, p_mod))
    alpha = ts.challenge("alpha")

    # --- stage 3: quotient ---------------------------------------------------
    N4 = 4 * N if N >= 6 else 8 * N
    dom4 = get_domain(ffr, N4, dev)
    period = N4 // N
    Ninv = pow(N, -1, q)
    col_coeffs = dict(l=l_b, r=r_b, o=o_b, z=z_b,
                      zs=ff_scale_powers(ffr, z_b, w),
                      ql=pk.ql_coeffs, qr=pk.qr_coeffs, qm=pk.qm_coeffs,
                      qo=pk.qo_coeffs, s1=pk.s1_coeffs, s2=pk.s2_coeffs,
                      s3=pk.s3_coeffs)
    scal = dict(beta=beta, gamma=gamma, alpha=alpha,
                alpha2=alpha * alpha % q, u=u, u2=u * u % q, Ninv=Ninv)
    if N >= (1 << RHO_MIN_LOG) and period > 1:
        h_dev = _rho_quotient(ffr, dom, dom4, col_coeffs, qkc_dev, pk,
                              pi2_dev, period, N, scal)
    else:
        h_dev = _s3_quotient(ffr, dom4, col_coeffs, qkc_dev,
                             pk.qcp_coeffs, pi2_dev, scal, period)
    shard = N + 2
    zero = h_dev.new_zeros((1, ffr.nw))
    h0 = torch.cat([h_dev[:shard], zero])
    h1 = torch.cat([h_dev[shard:2 * shard], zero])
    h2 = h_dev[2 * shard:3 * shard].clone()
    if statistical_zk:
        # h0 += b1 X^shard ; h1 += -b1 + b2 X^shard ; h2 -= b2
        b1, b2 = rnd(q), rnd(q)
        for h, at, v in ((h0, shard, b1), (h1, 0, q - b1), (h1, shard, b2),
                         (h2, 0, q - b2)):
            h[at:at + 1] = ops.add(ffr, h[at:at + 1], enc(ffr, [v], dev))
    c_h0, c_h1, c_h2 = (commit(h) for h in (h0, h1, h2))
    mark("quotient")

    for pt in (c_h0, c_h1, c_h2):
        ts.bind("zeta", ts.point_bytes(pt, p_mod))
    zeta = ts.challenge("zeta")

    # --- stage 4: evaluations + linearized polynomial ----------------------
    polys = dict(l=l_b, r=r_b, o=o_b, z=z_b, s1=pk.s1_coeffs,
                 s2=pk.s2_coeffs, s3=pk.s3_coeffs, ql=pk.ql_coeffs,
                 qr=pk.qr_coeffs, qm=pk.qm_coeffs, qo=pk.qo_coeffs,
                 qk=pk.qk_coeffs, qcps=pk.qcp_coeffs, pi2s=pi2_dev,
                 h0=h0, h1=h1, h2=h2)
    claimed, lin, zu = _s4_evals(ffr, polys, zeta, N, w, Ninv, beta, gamma,
                                 alpha, u, dev)
    _, lz, rz, oz, s1z, s2z = claimed[:6]
    qcpz = claimed[6:]
    mark("evals")

    # host scalar mirror for the verifier-side linearized digest
    zh_zeta = (pow(zeta, N, q) - 1) % q
    l1_zeta = zh_zeta * _inv0(zeta - 1, q) % q * Ninv % q
    a2l1 = alpha * alpha % q * l1_zeta % q
    t1 = (lz + beta * s1z + gamma) % q
    t2 = (rz + beta * s2z + gamma) % q
    _s1v = alpha * beta % q * t1 % q * t2 % q * zu % q
    idp = (lz + beta * zeta + gamma) % q
    idp = idp * ((rz + beta * u % q * zeta + gamma) % q) % q
    idp = idp * ((oz + beta * u % q * u % q * zeta + gamma) % q) % q
    coeff_z = (a2l1 - alpha * idp) % q
    zp2 = pow(zeta, N + 2, q)
    lin_digest = P._lin_digest_prover(
        pk, vk, c_z, (c_h0, c_h1, c_h2), lz, rz, oz, _s1v, coeff_z,
        zh_zeta, zp2, bsb22_pts, qcpz)
    digests = [lin_digest, c_l, c_r, c_o, vk.s_comm[0], vk.s_comm[1]] \
        + list(vk.qcp_c)
    fold_ch = P._fold_challenge(vk, digests, zeta, zu, claimed,
                                recursion_friendly)

    # --- stage 5: openings ---------------------------------------------------
    open_polys = [lin, l_b, r_b, o_b, pk.s1_coeffs, pk.s2_coeffs] \
        + list(pk.qcp_coeffs)
    fold_scals = []
    chp = 1
    folded_claim = 0
    for v in claimed:
        fold_scals.append(chp)
        folded_claim = (folded_claim + v * chp) % q
        chp = chp * fold_ch % q
    n2 = 2 * N if 2 * N >= lin.shape[0] else 4 * N
    dom2, xs2 = _DevDomain.get(ffr, n2, dev)
    bq, zq = _s5_open(ffr, dom2, xs2, open_polys, fold_scals, zeta,
                      folded_claim, z_b, w * zeta % q, zu)
    batch_h, z_open_h = commit(bq), commit(zq)
    mark("open")

    return P.PlonkProof(lro=[c_l, c_r, c_o], z=c_z,
                        h=[c_h0, c_h1, c_h2],
                        batched_h=batch_h, claimed=claimed,
                        z_shift_h=z_open_h, zu=zu, bsb22=bsb22_pts)
