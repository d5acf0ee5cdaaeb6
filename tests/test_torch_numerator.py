"""K14's plain path and the evaluations' batched K13 against the
reference, on the CPU:
  * the port's quotient numerator (plonk_device._numerator, which runs
    plonk_num.numerator_plain on CPU tensors) equals the reference's
    _numerator_t on the same seeded columns and challenges, in the rho
    form (one N-point shift: x = shift w^i, constant Z_H) and in the
    coset form (the 4N coset, period-4 Z_H tables), with a third of the
    port's rows in [p, 2p) (the reference gets the same values
    canonical);
  * the points' kept terms (x, the Z_H tables, Z_H(x) / (x - 1)) equal
    the reference's xd, zh_d, zhi_d and its batch_inv(xd - 1) path;
  * ops.dot_many (plain) equals the reference's dev_poly_eval column by
    column, for columns of N, N + 2 and N + 3 rows;
  * the kernel's rearrangement of the numerator (beta c w, alpha^2 N^-1
    times the kept Z_H(x) / (x - 1)) in plain steps gives its words;
  * the new wrappers reject bad shapes, mixed devices and non-int32
    words, and their card halves hand the kernels the columns, lengths,
    constants and scratch they expect (stub bindings).
The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
Tolerance: exact equality (canonical Montgomery words, host ints)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.backend import plonk_device as ref_pdev
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu_torch.backend import plonk_device as pdev
from gnark_tpu_torch.backend import plonk_num
from gnark_tpu_torch.ff import get_ff, ops
from gnark_tpu_torch.ff.mont_mul import mont_mul_plain
from gnark_tpu_torch.ntt import get_domain

NAME = "bn254_fr"
N = 16                   # the rho form's shift: N points; the coset: 4N
M = 4 * N                # rows of every numerator call here
torch.set_num_threads(2)


def _ints(n, rng):
    q = get_ff(NAME).p.modulus
    return [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]


def _lazy(vals):
    """Montgomery words of vals with p added to every third row."""
    f = get_ff(NAME)
    q = f.p.modulus
    raw = [v * f.p.R_mod % q for v in vals]
    raw = [v + q if i % 3 == 1 else v for i, v in enumerate(raw)]
    buf = b"".join(v.to_bytes(32, "little") for v in raw)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.int32)
                            .reshape(-1, 8).copy())


def _words(ref_limbs):
    return get_ff(NAME).to_words(
        torch.as_tensor(np.asarray(ref_limbs).astype(np.int64)))


@pytest.fixture(scope="module")
def case():
    """Seeded columns (M rows each) and challenges; the points of both
    forms, the port's and the reference's."""
    f, rf = get_ff(NAME), ref_get_ff(NAME)
    q = f.p.modulus
    rng = np.random.default_rng(10)
    vals = {k: _ints(M, rng) for k in plonk_num.NUM_COLS}
    vals["z"][5] = 1                              # z - 1 = 0 on a row
    ch = dict(zip(("beta", "gamma", "alpha", "u"), _ints(4, rng)))
    ch.update(alpha2=ch["alpha"] ** 2 % q, u2=ch["u"] ** 2 % q)
    g = f.p.generator % q
    shift = g * get_domain(f, 4 * M, "cpu").omega % q   # shift s = 1
    wpow = pdev.dev_powers(f, get_domain(f, M, "cpu").omega, M, "cpu")
    pts = {"rho": pdev._shift_points(f, wpow, M, shift),
           "coset": pdev._coset_points(f, M, 4, "cpu")}
    ninv = {"rho": pow(M, -1, q), "coset": pow(N, -1, q)}
    # the reference's points: rho as _rho_quotient makes them from the
    # key's powers of w, the coset from its _coset_consts
    one = jnp.asarray(rf.encode([1]))
    w = get_domain(f, M, "cpu").omega
    rwp = jnp.asarray(rf.encode([pow(w, i, q) for i in range(M)]))
    zh = (pow(shift, M, q) - 1) % q
    ref_pts = {"rho": (rf.mul(rwp, jnp.asarray(rf.encode([shift]))),
                       jnp.asarray(rf.encode([zh] * M)),
                       jnp.asarray(rf.encode([pow(zh, -1, q)] * M))),
               "coset": ref_pdev._coset_consts(rf, M, 4)}

    def zdiv(xd, zh_d):
        return rf.mul(zh_d, rf.batch_inv(rf.sub(xd, jnp.broadcast_to(
            one, xd.shape))))

    ref_zdiv = {k: jax.jit(zdiv)(*v[:2]) for k, v in ref_pts.items()}
    return dict(vals=vals, ch=ch, pts=pts, ninv=ninv, ref_pts=ref_pts,
                ref_zdiv=ref_zdiv)


@pytest.fixture(scope="module")
def ref_num(case):
    """The reference's _numerator_t in both forms (one jitted program:
    the two forms share their shapes)."""
    rf = ref_get_ff(NAME)
    cols = {k: jnp.asarray(rf.encode(v)) for k, v in case["vals"].items()}
    fn = jax.jit(ref_pdev._numerator_t, static_argnums=(0,))
    out = {}
    for form, (xd, zh_d, zhi_d) in case["ref_pts"].items():
        s = {k: jnp.asarray(rf.encode([v])) for k, v in case["ch"].items()}
        s["Ninv"] = jnp.asarray(rf.encode([case["ninv"][form]]))
        out[form] = _words(fn(rf, cols, xd, zh_d, zhi_d, s))
    return out


@pytest.mark.parametrize("form", ["rho", "coset"])
def test_numerator_equals_reference(form, case, ref_num):
    f = get_ff(NAME)
    cols = {k: _lazy(v) for k, v in case["vals"].items()}
    s = dict(case["ch"], Ninv=case["ninv"][form])
    got = pdev._numerator(f, cols, case["pts"][form], s)
    assert got.shape == (M, f.nw)
    assert torch.equal(got, ref_num[form])


@pytest.mark.parametrize("form", ["rho", "coset"])
def test_points_terms_equal_reference(form, case):
    f = get_ff(NAME)
    pts = case["pts"][form]
    xd, zh_d, zhi_d = (_words(v) for v in case["ref_pts"][form])
    assert pts.period == (1 if form == "rho" else 4)
    assert torch.equal(pts.x(f), xd)
    for vals, want in ((pts.zh, zh_d), (pts.zhi, zhi_d)):
        got = pts.table(f, vals)
        if isinstance(got, int):
            got = pdev.enc(f, [got] * M, "cpu")
        assert torch.equal(got, want)
    assert torch.equal(pts.zdiv(f), _words(case["ref_zdiv"][form]))
    assert pts.zdiv(f) is pts.zdiv(f)           # made once, then kept


def test_kernel_constants_give_the_numerator(case):
    """The kernel's rearrangement (csrc/plonk_num.cu), in plain steps over
    the kept terms: beta x as (beta c) w, L1(x) (z - 1) as alpha^2 N^-1
    times Z_H(x) / (x - 1) times (z - 1), 1 / Z_H by the table: the
    step-by-step numerator's words, in both forms."""
    f = get_ff(NAME)
    q = f.p.modulus
    cols = {k: _lazy(v) for k, v in case["vals"].items()}

    def mul(a, b):
        return mont_mul_plain(f, a, b)

    def add(a, b):
        return ops.add_plain(f, a, b)

    for form, pts in case["pts"].items():
        s = dict(case["ch"], Ninv=case["ninv"][form])
        bc = s["beta"] * pts.c % q
        gamma, beta, kbc, kbuc, kbu2c, alpha, a2n = (
            pdev.enc(f, [v], "cpu") for v in (
                s["gamma"], s["beta"], bc, bc * s["u"], bc * s["u2"],
                s["alpha"], s["alpha2"] * s["Ninv"]))

        def lin(v, k, col):
            return add(add(v, mul(k, col)), gamma)

        l, r, o = cols["l"], cols["r"], cols["o"]
        gate = add(add(mul(cols["ql"], l), mul(cols["qr"], r)),
                   mul(cols["qm"], mul(l, r)))
        gate = add(add(gate, mul(cols["qo"], o)), cols["qk"])
        sp = mul(mul(lin(l, beta, cols["s1"]), lin(r, beta, cols["s2"])),
                 lin(o, beta, cols["s3"]))
        idp = mul(mul(lin(l, kbc, pts.w), lin(r, kbuc, pts.w)),
                  lin(o, kbu2c, pts.w))
        ordering = ops.sub_plain(f, mul(sp, cols["zs"]),
                                 mul(idp, cols["z"]))
        loc = mul(pts.zdiv(f), ops.sub_plain(f, cols["z"],
                                             pdev.enc(f, [1], "cpu")))
        num = add(gate, add(mul(alpha, ordering), mul(a2n, loc)))
        zhi = pdev.enc(f, list(pts.zhi), "cpu")[
            torch.arange(M) % pts.period]
        assert torch.equal(mul(num, zhi), pdev._numerator(f, cols, pts, s))


def test_dot_many_equals_reference_evaluations():
    """dot_many's columns of N, N + 2 and N + 3 rows against the
    reference's dev_poly_eval of each at the same powers (the reference
    gets each column zero-padded to N + 3 rows: one compiled shape)."""
    f, rf = get_ff(NAME), ref_get_ff(NAME)
    q = f.p.modulus
    rng = np.random.default_rng(11)
    zeta = _ints(1, rng)[0]
    lens = (N, N + 2, N + 3)
    vals = [_ints(n, rng) for n in lens]
    pows = pdev.dev_powers(f, zeta, N + 3, "cpu")
    got = ops.dot_many(f, [_lazy(v) for v in vals], pows)
    assert got.shape == (3, f.nw)
    rpows = jnp.asarray(rf.encode([pow(zeta, i, q) for i in range(N + 3)]))
    want = [ref_pdev.dev_poly_eval(rf, jnp.asarray(rf.encode(
        v + [0] * (N + 3 - len(v)))), rpows) for v in vals]
    assert [int(v) for v in f.decode_words(got)] == want
    # the k = 1 case is dot's
    assert torch.equal(got[1:2], ops.dot(f, _lazy(vals[1]), pows[:N + 2]))


def test_wrappers_check_their_arguments(case):
    f = get_ff(NAME)
    a = _lazy(case["vals"]["l"])
    meta = torch.empty(a.shape, dtype=torch.int32, device="meta")
    for cols, pows in (([], a),                   # no column
                       ([a[:0]], a),              # an empty one
                       ([a[:, :4]], a),           # not (n, nw)
                       ([a], a[:M - 1]),          # longer than pows
                       ([a.long()], a), ([a], a.long()),
                       ([meta], a), ([a, meta], a), ([a], meta)):
        with pytest.raises(ValueError):
            ops.dot_many(f, cols, pows)
    cols = {k: _lazy(v) for k, v in case["vals"].items()}
    s = dict(case["ch"], Ninv=case["ninv"]["rho"])
    pts = case["pts"]["rho"]
    bad_cols = ({k: v for k, v in cols.items() if k != "qk"},
                dict(cols, zs=cols["zs"][:M - 1]),
                dict(cols, ql=cols["ql"].long()),
                dict(cols, s3=torch.empty(cols["s3"].shape,
                                          dtype=torch.int32, device="meta")))
    for bad in bad_cols:
        with pytest.raises(ValueError):
            plonk_num.plonk_numerator(f, bad, pts, s)
    for bad_pts in (dataclasses.replace(pts, zh=(1,) * 9, zhi=(1,) * 9),
                    dataclasses.replace(pts, zhi=(1, 2)),
                    dataclasses.replace(pts, w=pts.w[:M - 1])):
        with pytest.raises(ValueError):
            plonk_num.plonk_numerator(f, cols, bad_pts, s)


def test_card_halves_marshal_their_arguments(case, monkeypatch):
    """What the card halves hand their kernels, read through the pointers
    by stub bindings (CPU tensors stand in for the card's): K14 the 15
    column pointers in csrc/plonk_num.cu's order and its constants
    (gamma, beta, beta c, beta u c, beta u^2 c, alpha, alpha^2 N^-1, the
    1 / Z_H table); K13 the columns, their lengths and one zeroed
    scratch a stream, kept across calls."""
    import ctypes

    from gnark_tpu_torch import cuda
    f = get_ff(NAME)
    q = f.p.modulus
    seen = {}

    def num_stub(cols, out, consts, n, period, fconsts, stream):
        seen["num"] = ([ctypes.c_void_p.from_address(cols + 8 * j).value
                        for j in range(15)], f.decode_words(np.frombuffer(
                            ctypes.string_at(consts, 32 * (7 + period)),
                            dtype=np.int32).reshape(-1, 8)), n, period)
        return 0

    def dot_stub(cols, lens, pw, out, scratch, k, n, consts, stream):
        seen.setdefault("dot", []).append((
            [ctypes.c_void_p.from_address(cols + 8 * j).value
             for j in range(k)],
            [ctypes.c_longlong.from_address(lens + 8 * j).value
             for j in range(k)], pw, n, scratch,
            ctypes.string_at(scratch, 32 * (1 + ops.DOT_MAXB * ops.DOT_K))))
        return 0

    monkeypatch.setattr(plonk_num, "_fn", lambda field: num_stub)
    monkeypatch.setattr(ops, "_fn", lambda name, field: dot_stub)
    monkeypatch.setattr(cuda, "stream", lambda t: 0)
    monkeypatch.setattr(cuda, "dev_words", lambda t, what, shape=None: t)
    cols = {k: _lazy(v) for k, v in case["vals"].items()}
    pts = case["pts"]["coset"]
    s = dict(case["ch"], Ninv=case["ninv"]["coset"])
    assert plonk_num._numerator_card(f, cols, pts, s).shape == (M, f.nw)
    ptrs, consts, n, period = seen["num"]
    assert ptrs == [cols[k].data_ptr() for k in plonk_num.NUM_COLS] + [
        pts.w.data_ptr(), pts.zdiv(f).data_ptr()]
    bc = s["beta"] * pts.c
    assert [int(v) for v in consts] == [v % q for v in (
        s["gamma"], s["beta"], bc, bc * s["u"], bc * s["u2"], s["alpha"],
        s["alpha2"] * s["Ninv"])] + list(pts.zhi)
    assert (n, period) == (M, 4)
    a, b = cols["l"], cols["r"][:M - 3]
    for _ in range(2):
        assert ops._dot_card(f, [a, b], a).shape == (2, f.nw)
    (p1, l1, pw, n1, s1, z1), (_, _, _, _, s2, _) = seen["dot"]
    assert p1 == [a.data_ptr(), b.data_ptr()] and l1 == [M, M - 3]
    assert (pw, n1) == (a.data_ptr(), M) and s1 == s2
    assert z1 == bytes(len(z1))
