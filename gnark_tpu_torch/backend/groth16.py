"""Groth16 Setup, Prove and Verify on the card (BN254, BLS12-381,
BLS12-377 and BW6-761, whose G2 lies over Fp; Grumpkin has no pairing).

Counterpart of gnark_tpu.backend.groth16 without a mesh (reference
backend/groth16/bn254/{setup,prove,verify}.go):

  * Setup: toxic waste and the Lagrange-basis A/B/C column evaluation on
    the host (setup.go:346-436 recurrence, batch-inverted), then one G1
    and one G2 fixed-base ladder (msm/fixed_base: kernels K7, K6) and
    their affine conversion (K1); the key columns stay on the card.
  * Prove: witness solve (host, native solver; the BSB22 hint computes
    each Pedersen commitment and its proof of knowledge with two device
    MSMs) -> upload of the solver's raw words -> computeH = 3 iFFT + 3
    coset FFT + pointwise (a*b - c)*den + coset iFFT (kernels K5 below
    2^14, K2 above; K1) -> four G1 MSMs and one G2 MSM (msm/pippenger
    msm_raw: the bucket path, kernels K4 and K3, or under
    GNARK_TPU_MSM_IMPL=scan the scan path, kernels K6, K8 and K7) ->
    affine conversion of the five results and the small combination with
    r, s (host ints), then the fold of the commitments' PoKs.
  * Verify: on the host, e(Ar, Bs) == e(alpha, beta) e(kSum, gamma)
    e(Krs, delta) through one Tate multi-pairing (pairing/), after the
    commitment values are recomputed and the folded PoK is checked.

Keys also come from `dummy_setup`, or from plain arrays through
`proving_key_from_arrays`. The commitment hashes: gnark's default,
"evm", and the recursion-friendly MiMC ones (True: over the 2-chain
outer field; "self": over fr, coordinates as emulated limbs;
backend/transcript).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import secrets
import time

import numpy as np
import torch

from gnark_tpu_torch.backend import gnark_fs
from gnark_tpu_torch.backend.transcript import (mimc_point_writes,
                                               outer_mimc_field)
from gnark_tpu_torch.constraint import ConstraintSystem, solve_auto
from gnark_tpu_torch.cuda import check_curve, resolve_device
from gnark_tpu_torch.ec import curves as curves_mod
from gnark_tpu_torch.ec import host
from gnark_tpu_torch.ec.fp2 import FF2, get_ff2
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_sub_mul
from gnark_tpu_torch.logger import get_logger
from gnark_tpu_torch.msm.bucket import group_b3
from gnark_tpu_torch.msm.fixed_base import batch_scalar_mul, jac_to_affine
from gnark_tpu_torch.msm.pippenger import msm_raw
from gnark_tpu_torch.ntt import get_domain
from gnark_tpu_torch.pairing import get_pairing
from gnark_tpu_torch.std.hash.mimc import MiMC


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n & (n - 1) or n == 0 else n


def _batch_inv(vals, q):
    """Montgomery batch inversion of a list of nonzero ints."""
    n = len(vals)
    pre = [1] * (n + 1)
    for i, v in enumerate(vals):
        pre[i + 1] = pre[i] * v % q
    inv_all = pow(pre[n], -1, q)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = pre[i] * inv_all % q
        inv_all = inv_all * vals[i] % q
    return out


@dataclasses.dataclass
class CommitmentKey:
    """Pedersen key of one BSB22 commitment (reference CommitmentKey;
    gnark-crypto pedersen.ProvingKey / VerifyingKey)."""
    wires: tuple          # committed wire ids (public first)
    basis: tuple          # device (x, y, inf): one per PRIVATE committed wire
    basis_exp_sigma: tuple  # device (x, y, inf): sigma * basis
    g2_sigma: tuple       # host G2 point sigma * g2 (verifier side)
    nb_public: int = 0    # leading wires that are hashed, not committed


@dataclasses.dataclass
class ProvingKey:
    curve: curves_mod.Curve
    domain_n: int
    # device tensors: (x words, y words, inf bool) affine batches
    g1_a: tuple          # per wire
    g1_b: tuple          # per wire
    g1_z: tuple          # per domain index (n)
    g1_k: tuple          # per private wire
    g2_b: tuple          # per wire: x, y (n, 2, nw) over Fp2, (n, nw)
                         # over Fp (BW6-761)
    # host points
    g1_alpha: tuple
    g1_beta: tuple
    g1_delta: tuple
    g2_beta: tuple
    g2_delta: tuple
    commitment_keys: list = dataclasses.field(default_factory=list)

    @property
    def device(self) -> torch.device:
        return self.g1_a[0].device


@dataclasses.dataclass
class VerifyingKey:
    curve: curves_mod.Curve
    g1_k: list           # host affine points: publics then commitment wires
    g2_gamma_neg: tuple
    g2_delta_neg: tuple
    e_alpha_beta: tuple  # GT element (precomputed pairing)
    g1_alpha: tuple
    g2_beta: tuple
    g2_gamma: tuple
    g2_delta: tuple
    commitment_g2_sigma: list = dataclasses.field(default_factory=list)
    commitment_pac: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Proof:
    ar: tuple            # G1 affine (host ints)
    krs: tuple           # G1 affine
    bs: tuple            # G2 affine
    commitments: list = dataclasses.field(default_factory=list)
    poks: list = dataclasses.field(default_factory=list)


def _pac_indices(cs, nb_pub):
    """Per commitment: 1-based indices into the EXTENDED public vector
    (publics then commitment values) of the hashed public and
    prior-commitment committed wires (the reference's
    vk.PublicAndCommitmentCommitted, verify.go:79-103)."""
    cm_idx_of_wire = {cm.commitment_wire: ci
                      for ci, cm in enumerate(cs.commitments)}
    out = []
    for cm in cs.commitments:
        idxs = []
        for w in cm.committed_wires[:cm.nb_public_committed]:
            if w < nb_pub:
                idxs.append(w)
            else:
                idxs.append(nb_pub + cm_idx_of_wire[w])
        out.append(tuple(idxs))
    return out


def _hash_to_field(curve, point, recursion=False, public_committed=()) -> int:
    """Commitment wire value from a commitment point. Default: gnark's
    fr/hash_to_field with dst "bsb22-commitment" over the uncompressed
    point bytes, then the public-committed values
    (backend/groth16/bn254/prove.go:57-58,87-96; bit-exact).
    recursion="evm": sha256(x || y) mod r, the Solidity-computable
    variant. recursion=True: MiMC over the 2-chain outer field,
    truncated to rbits - 8 bits (std/recursion/groth16's in-circuit
    recomputation); recursion="self": MiMC over the curve's own fr with
    the coordinates split into emulated limbs."""
    if recursion == "evm":
        # the reference swaps HashToFieldFn for a plain evm hash when
        # targeting the contract (verify.go:157-159)
        if public_committed:
            raise NotImplementedError(
                "public committed wires with the evm hash mode")
        nb = -(-curve.fp.modulus.bit_length() // 8)
        raw = (b"\x00" * 2 * nb if point is host.INF else
               point[0].to_bytes(nb, "big") + point[1].to_bytes(nb, "big"))
        return int.from_bytes(hashlib.sha256(raw).digest(),
                              "big") % curve.fr.modulus
    if recursion and public_committed:
        raise NotImplementedError(
            "public committed wires with recursion-friendly hashes")
    if recursion:
        h = MiMC(outer_mimc_field(curve, recursion))
        h.write(int.from_bytes(b"BSB22-Groth16", "big"))
        h.write(*mimc_point_writes(
            curve, None if point is host.INF else point, recursion))
        mask = (1 << (curve.fr.modulus.bit_length() - 8)) - 1
        return h.sum() & mask
    return gnark_fs.bsb22_groth16_value(
        curve, None if point is host.INF else point,
        list(public_committed), curve.fr.modulus)


def _g2_field(curve):
    """The field G2's coordinates lie in: Fp2, or Fp itself (BW6-761)."""
    if curve.g2_over_fp2:
        return get_ff2(curve.fp.name, curve.fp2_nr)
    return get_ff(curve.fp.name)


def _encode_affine_host(ff, pts, device):
    """Host affine points (or INF) -> device (x words, y words, inf)."""
    zero = (0, 0) if isinstance(ff, FF2) else 0
    xs = [zero if p is host.INF else p[0] for p in pts]
    ys = [zero if p is host.INF else p[1] for p in pts]
    inf = torch.tensor([p is host.INF for p in pts], device=device)
    return (torch.as_tensor(ff.encode_words(xs), device=device),
            torch.as_tensor(ff.encode_words(ys), device=device), inf)


def _to_affine_host(ff, hf, kind, P):
    """A projective ("proj") or Jacobian ("jac") point of (1, Lw) words
    on the device -> host affine point."""
    shape = (1, 2, ff.nw) if isinstance(ff, FF2) else (1, ff.nw)
    X, Y, Z = (ff.decode_words(a.reshape(shape))[0] for a in P)
    if isinstance(ff, FF2):
        X, Y, Z = (tuple(int(c) for c in v) for v in (X, Y, Z))
    else:
        X, Y, Z = int(X), int(Y), int(Z)
    if hf.is_zero(Z):
        return host.INF
    zi = hf.inv(Z)
    if kind == "jac":
        zi2 = hf.mul(zi, zi)
        return (hf.mul(X, zi2), hf.mul(Y, hf.mul(zi2, zi)))
    return (hf.mul(X, zi), hf.mul(Y, zi))


def _msm_affine_host(ff, hf, points, scalars, nbits, b3):
    """The routed MSM (msm_raw) of device points and scalar words in the
    group whose 3 b is b3 -> host affine point; no points give the point
    at infinity."""
    if points[0].shape[0] == 0:
        return host.INF
    return _to_affine_host(ff, hf, *msm_raw(ff, points, scalars, nbits,
                                            b3=b3))


def _scalar_words(vals, nw: int, device) -> torch.Tensor:
    """Plain ints in [0, 2^(32 nw)) -> (n, nw) int32 words on device."""
    raw = b"".join(v.to_bytes(4 * nw, "little") for v in vals)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.int32).reshape(-1, nw).copy()).to(device)


def _words_u64(arr_u64, device) -> torch.Tensor:
    """(..., nl) uint64 host limbs -> (..., 2*nl) int32 device words."""
    from gnark_tpu_torch.ff.mont import FF
    return torch.from_numpy(FF.u64_view(arr_u64).view(np.int32)).to(device)


def _mark_fn(timings, device, log, what_prefix):
    """Phase timer: mark(what) adds the seconds since the last mark to
    timings[what] (the card synchronized first); a no-op without a dict."""
    t0 = time.perf_counter()

    def mark(what):
        nonlocal t0
        if timings is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        timings[what] = timings.get(what, 0.0) + t - t0
        log.debug("%s phase %-10s %.3fs", what_prefix, what, t - t0)
        t0 = t
    return mark


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

def setup_scalars(cs: ConstraintSystem, curve, rng=None) -> dict:
    """The host half of Setup: toxic waste from rng (the reference's
    draws, in its order), the Lagrange values L_i(t), and the scalars of
    the one G1 and the one G2 batch:
      g1 = [alpha, beta, delta] + A + B + Z + vkK + pkK + ck,
      g2 = [beta, delta, gamma] + sigmas + B.
    vkK holds the public wires, then one entry per commitment wire; pkK
    is 0 (infinity) on committed and commitment wires; ck holds, per
    commitment, its Pedersen basis scalars then the same times sigma
    (reference groth16.py:272-307, setup.go:140-178)."""
    q = curve.fr.modulus
    if q != cs.q:
        raise ValueError("constraint system field != curve scalar field")
    rnd = rng.randrange if rng is not None else \
        (lambda n: secrets.randbelow(n - 1) + 1)
    nb_con, nb_wires, nb_pub = cs.nb_constraints, cs.nb_wires, cs.nb_public
    N = _next_pow2(max(nb_con, 1))

    t, alpha, beta, gamma, delta = (rnd(q) or 1 for _ in range(5))
    gamma_inv, delta_inv = pow(gamma, -1, q), pow(delta, -1, q)

    # L_i(t), i = 0..nb_con (recurrence, setup.go:346-436)
    w = curve.fr.root_of_unity(N)
    wi = 1
    tw = []
    for _ in range(nb_con + 1):
        tw.append((t - wi) % q)
        wi = wi * w % q
    tw_inv = _batch_inv([v if v else 1 for v in tw], q)
    L = (pow(t, N, q) - 1) * tw_inv[0] % q * pow(N, -1, q) % q
    A = [0] * nb_wires
    B = [0] * nb_wires
    C = [0] * nb_wires
    for j, con in enumerate(cs.r1cs):
        for coeff, wire in con.l:
            A[wire] = (A[wire] + coeff * L) % q
        for coeff, wire in con.r:
            B[wire] = (B[wire] + coeff * L) % q
        for coeff, wire in con.o:
            C[wire] = (C[wire] + coeff * L) % q
        L = L * w % q * tw[j] % q * tw_inv[j + 1] % q

    # K columns: (beta*A + alpha*B + C) / gamma (public, commitment and
    # committed wires) or / delta (other private wires)
    kv = [(beta * A[i] + alpha * B[i] + C[i]) % q for i in range(nb_wires)]
    vkK = [v * gamma_inv % q for v in kv[:nb_pub]]
    pkK = [v * delta_inv % q for v in kv[nb_pub:]]
    skip = set()       # private committed wires and commitment wires
    for cm in cs.commitments:
        skip.update(cm.committed_wires[cm.nb_public_committed:])
        skip.add(cm.commitment_wire)
    for i in skip:
        pkK[i - nb_pub] = 0
    vkK += [kv[cm.commitment_wire] * gamma_inv % q for cm in cs.commitments]
    ckK = [[kv[w] * gamma_inv % q
            for w in cm.committed_wires[cm.nb_public_committed:]]
           for cm in cs.commitments]
    sigmas = [rnd(q) or 1 for _ in cs.commitments]
    ck = []
    for sc, sg in zip(ckK, sigmas):
        ck += sc + [v * sg % q for v in sc]
    # Z column: (t^N - 1) / delta * t^i
    zdt = (pow(t, N, q) - 1) * delta_inv % q
    Z = []
    for _ in range(N):
        Z.append(zdt)
        zdt = zdt * t % q
    return {"N": N, "alpha": alpha, "beta": beta, "gamma": gamma,
            "delta": delta, "sigmas": sigmas,
            "ck_sizes": [len(sc) for sc in ckK],
            "g1": [alpha, beta, delta] + A + B + Z + vkK + pkK + ck,
            "g2": [beta, delta, gamma] + sigmas + B}


def _host_points(ff, x, y, inf) -> list:
    """Affine words (a few rows) -> host points."""
    xs, ys = ff.decode_words(x.cpu()), ff.decode_words(y.cpu())
    out = []
    for i, at_inf in enumerate(inf.tolist()):
        if at_inf:
            out.append(host.INF)
        elif isinstance(ff, FF2):
            out.append((tuple(int(c) for c in xs[i]),
                        tuple(int(c) for c in ys[i])))
        else:
            out.append((int(xs[i]), int(ys[i])))
    return out


def setup(cs: ConstraintSystem, curve_name: str, rng=None, device=None,
          timings: dict | None = None):
    """Groth16 trusted setup (insecure single-party, as the reference's)
    on `device` (None: the card). Returns (pk, vk); the same rng seed as
    the reference's setup gives the same keys.

    timings: if a dict, filled with seconds per phase (scalars, encode,
    g1_ladder, g2_ladder, to_affine, vk)."""
    curve = curves_mod.CURVES[curve_name]
    device = resolve_device(device)
    check_curve(curve, device)
    mark = _mark_fn(timings, device, get_logger("gnark_tpu_torch"), "setup")
    s = setup_scalars(cs, curve, rng)
    mark("scalars")
    N, nb_wires, nb_pub = s["N"], cs.nb_wires, cs.nb_public
    ffp, ffr, ff2 = get_ff(curve.fp.name), get_ff(curve.fr.name), \
        _g2_field(curve)
    nbits = curve.fr.bits

    def words(vals):
        return torch.as_tensor(ffr.encode_words(vals, mont=False),
                               device=device)

    g1_sc, g2_sc = words(s["g1"]), words(s["g2"])
    g1_base, g2_base = (_encode_affine_host(f, [g], device)[:2]
                        for f, g in ((ffp, curve.g1), (ff2, curve.g2)))
    mark("encode")
    R = batch_scalar_mul(ffp, g1_base, nbits, g1_sc)
    mark("g1_ladder")
    x, y, inf = jac_to_affine(ffp, R)
    del R
    mark("to_affine")
    R = batch_scalar_mul(ff2, g2_base, nbits, g2_sc)
    mark("g2_ladder")
    x2, y2, inf2 = jac_to_affine(ff2, R)
    del R
    mark("to_affine")

    def cols(lo, hi, g2=False):
        a, b, c = (x2, y2, inf2) if g2 else (x, y, inf)
        if g2 and isinstance(ff2, FF2):
            return (a[lo:hi].reshape(-1, 2, ff2.nw),
                    b[lo:hi].reshape(-1, 2, ff2.nw), c[lo:hi])
        return a[lo:hi], b[lo:hi], c[lo:hi]

    ncm = len(cs.commitments)
    o_a, o_b, o_z = 3, 3 + nb_wires, 3 + 2 * nb_wires
    o_vk = o_z + N
    o_pk = o_vk + nb_pub + ncm
    o_ck = o_pk + nb_wires - nb_pub
    g1_alpha, g1_beta, g1_delta = _host_points(ffp, *cols(0, 3))
    g2_beta, g2_delta, g2_gamma = _host_points(ff2, *cols(0, 3, True))
    g2_sigmas = _host_points(ff2, *cols(3, 3 + ncm, True))
    g1_vk = _host_points(ffp, *cols(o_vk, o_pk))
    cks = []
    for cm, nb, g2s in zip(cs.commitments, s["ck_sizes"], g2_sigmas):
        cks.append(CommitmentKey(
            wires=cm.committed_wires, basis=cols(o_ck, o_ck + nb),
            basis_exp_sigma=cols(o_ck + nb, o_ck + 2 * nb), g2_sigma=g2s,
            nb_public=cm.nb_public_committed))
        o_ck += 2 * nb
    pk = ProvingKey(
        curve=curve, domain_n=N,
        g1_a=cols(o_a, o_b), g1_b=cols(o_b, o_z), g1_z=cols(o_z, o_vk),
        g1_k=cols(o_pk, o_pk + nb_wires - nb_pub),
        g2_b=cols(3 + ncm, 3 + ncm + nb_wires, True),
        g1_alpha=g1_alpha, g1_beta=g1_beta, g1_delta=g1_delta,
        g2_beta=g2_beta, g2_delta=g2_delta, commitment_keys=cks)
    f2h = curve.host_g2_field
    vk = VerifyingKey(
        curve=curve, g1_k=g1_vk,
        g2_gamma_neg=host.ec_neg(f2h, g2_gamma),
        g2_delta_neg=host.ec_neg(f2h, g2_delta),
        e_alpha_beta=get_pairing(curve_name).pair(g1_alpha, g2_beta),
        g1_alpha=g1_alpha, g2_beta=g2_beta, g2_gamma=g2_gamma,
        g2_delta=g2_delta, commitment_g2_sigma=list(g2_sigmas),
        commitment_pac=_pac_indices(cs, nb_pub))
    mark("vk")
    return pk, vk


@functools.lru_cache(maxsize=None)
def _g1_stage_fn(curve_name: str, N: int, nb_pub: int, nbits: int,
                 device: str):
    """The G1 side of prove: computeH feeding the four G1 MSMs (Ar, Bs1,
    Krs2, Krs; routed by msm_raw at each call), then the affine
    conversion. f(...) returns (the four affine host points, h in plain
    words)."""
    curve = curves_mod.CURVES[curve_name]
    ffr = get_ff(curve.fr.name)
    ffp = get_ff(curve.fp.name)
    hfp = curve.host_fp
    b3 = group_b3(curve)
    dom = get_domain(ffr, N, device)
    r2 = torch.as_tensor(ffr.encode_words([ffr.p.R2_mod], mont=False),
                         device=device)
    one = torch.as_tensor(ffr.encode_words([1], mont=False), device=device)

    def f(abc_raw, wire_raw, den_m, g1_a, g1_b, g1_z, g1_k, mark=None):
        mark = mark or (lambda what: None)
        av, bv, cv = (mont_mul(ffr, abc_raw[i], r2) for i in range(3))
        ac = dom.fft(dom.ifft(av), coset=True)
        bc = dom.fft(dom.ifft(bv), coset=True)
        cc = dom.fft(dom.ifft(cv), coset=True)
        hval = mont_mul_sub_mul(ffr, ac, bc, cc, den_m)
        h_plain = mont_mul(ffr, dom.ifft(hval, coset=True), one)
        mark("computeH")
        ar = msm_raw(ffp, g1_a, wire_raw, nbits, b3=b3)
        bs1 = msm_raw(ffp, g1_b, wire_raw, nbits, b3=b3)
        zp = tuple(a[: N - 1] for a in g1_z)
        krs2 = msm_raw(ffp, zp, h_plain[: N - 1], nbits, b3=b3)
        krs = msm_raw(ffp, g1_k, wire_raw[nb_pub:], nbits, b3=b3)
        mark("g1_msm")
        aff = [_to_affine_host(ffp, hfp, *P) for P in (ar, bs1, krs2, krs)]
        mark("to_affine")
        return aff, h_plain
    return f


@functools.lru_cache(maxsize=None)
def _g2_stage_fn(curve_name: str, nbits: int):
    curve = curves_mod.CURVES[curve_name]
    ff2 = _g2_field(curve)
    b3 = group_b3(curve, g2=True)

    def f(g2_b, wire_raw, mark=None):
        mark = mark or (lambda what: None)
        r = msm_raw(ff2, g2_b, wire_raw, nbits, b3=b3)
        mark("g2_msm")
        aff = _to_affine_host(ff2, curve.host_g2_field, *r)
        mark("to_affine")
        return aff
    return f


def _bsb22_hint(pk, device, commitments, poks, cm_vals, recursion,
                clock):
    """The solver override of the commitment hint (prove.go:72-99): the
    Pedersen commitment C of the private committed values and its proof
    of knowledge, two routed device MSMs over the key's bases (the
    reference computes the same points with host.ec_msm); the wire value
    is the hash of C and the hashed public-committed values. clock[0]
    collects the seconds spent here."""
    curve = pk.curve
    ffp, ffr = get_ff(curve.fp.name), get_ff(curve.fr.name)
    ck_iter = iter(pk.commitment_keys)

    def hint(qq, inputs):
        t = time.perf_counter()
        key = next(ck_iter)
        vals = [v % qq for v in inputs]
        hashed, priv = vals[:key.nb_public], vals[key.nb_public:]
        sc = _scalar_words(priv, ffr.nw, device)
        C, pok = (_msm_affine_host(ffp, curve.host_fp, b, sc, curve.fr.bits,
                                   group_b3(curve))
                  for b in (key.basis, key.basis_exp_sigma))
        commitments.append(C)
        poks.append(pok)
        cm_vals.append(_hash_to_field(curve, C, recursion,
                                      public_committed=hashed))
        clock[0] += time.perf_counter() - t
        return [cm_vals[-1]]
    return hint


def prove(cs: ConstraintSystem, pk: ProvingKey, public, secret, rng=None,
          hint_overrides=None, recursion_friendly=False, mesh=None,
          timings: dict | None = None, device=None):
    """Groth16 proof of the assignment (public, secret) on `device`
    (None: the card), where pk must live.

    rng: a random.Random for r and s (default: the secrets module); the
    same seed as the reference's prove gives the same Proof.
    recursion_friendly: False; "evm" (the commitment value is sha256(C)
    mod r); True or "self" (MiMC, _hash_to_field). Under any of the
    three the PoKs stay one per commitment.
    timings: if a dict, filled with seconds per phase (solve, commit,
    upload, computeH, g1_msm, g2_msm, to_affine, combine; commit is the
    commitment hint's device MSMs, which run inside the solve and are
    taken out of its time); the card is synchronized at each phase
    boundary for this."""
    if mesh is not None:
        raise NotImplementedError("prove(mesh=...) is not ported")
    if len(pk.commitment_keys) not in (0, len(cs.commitments)):
        raise ValueError(f"the proving key has {len(pk.commitment_keys)} "
                         f"commitment keys, the circuit "
                         f"{len(cs.commitments)} commitments")
    curve = pk.curve
    q = curve.fr.modulus
    rnd = rng.randrange if rng is not None else \
        (lambda n: secrets.randbelow(n))
    device = resolve_device(device)
    check_curve(curve, device)
    if pk.device != device:
        raise ValueError(f"the proving key is on {pk.device}, not {device}")
    mark = _mark_fn(timings, device, get_logger("gnark_tpu_torch"), "prove")
    commitments, poks, cm_vals, clock = [], [], [], [0.0]
    overrides = dict(hint_overrides or {})
    if pk.commitment_keys:
        overrides["bsb22"] = _bsb22_hint(pk, device, commitments, poks,
                                         cm_vals, recursion_friendly, clock)
    sol = solve_auto(cs, public, secret, hint_overrides=overrides)
    mark("solve")
    if timings is not None and pk.commitment_keys:
        timings["solve"] -= clock[0]
        timings["commit"] = timings.get("commit", 0.0) + clock[0]
    N = pk.domain_n
    ffr = get_ff(curve.fr.name)
    nl = (curve.fr.bits + 63) // 64
    m64 = (1 << 64) - 1
    pad = N - len(sol.a)
    abc_u64 = getattr(sol, "abc_u64", None)
    if abc_u64 is not None and len(sol.a) == abc_u64.shape[1]:
        zp = np.zeros((3, pad, abc_u64.shape[2]), dtype=np.uint64)
        abc_p = np.concatenate([abc_u64, zp], axis=1) if pad else abc_u64
    else:
        abc_p = np.zeros((3, N, nl), dtype=np.uint64)
        for j, col in enumerate((sol.a, sol.b, sol.c)):
            for i, v in enumerate(col):
                for li in range(nl):
                    abc_p[j, i, li] = (v >> (64 * li)) & m64
    vals_u64 = getattr(sol, "values_u64", None)
    if vals_u64 is None:
        vals_u64 = np.zeros((len(sol.values), nl), dtype=np.uint64)
        for i, v in enumerate(sol.values):
            for li in range(nl):
                vals_u64[i, li] = (v >> (64 * li)) & m64
    abc_raw = _words_u64(abc_p, device)
    wire_raw = _words_u64(vals_u64, device)
    den = pow(pow(curve.fr.generator, N, q) - 1, -1, q)
    den_m = torch.as_tensor(ffr.encode_words([den]), device=device)
    mark("upload")

    nbits = curve.fr.bits
    g1_aff, _ = _g1_stage_fn(curve.name, N, cs.nb_public, nbits,
                             str(device))(
        abc_raw, wire_raw, den_m, pk.g1_a, pk.g1_b, pk.g1_z, pk.g1_k,
        mark=mark)
    ar_m, bs1_m, krs2_m, krs_m = g1_aff
    bs2_m = _g2_stage_fn(curve.name, nbits)(pk.g2_b, wire_raw, mark=mark)

    # --- host combination (tiny) ---
    f1 = curve.host_fp
    f2h = curve.host_g2_field
    r, s = rnd(q), rnd(q)
    ar = host.ec_add(f1, host.ec_add(f1, ar_m, pk.g1_alpha),
                     host.ec_mul(f1, pk.g1_delta, r))
    bs1 = host.ec_add(f1, host.ec_add(f1, bs1_m, pk.g1_beta),
                      host.ec_mul(f1, pk.g1_delta, s))
    bs = host.ec_add(f2h, host.ec_add(f2h, bs2_m, pk.g2_beta),
                     host.ec_mul(f2h, pk.g2_delta, s))
    krs = host.ec_add(f1, krs_m, krs2_m)
    krs = host.ec_add(f1, krs, host.ec_mul(f1, pk.g1_delta, (-r * s) % q))
    krs = host.ec_add(f1, krs, host.ec_mul(f1, ar, s))
    krs = host.ec_add(f1, krs, host.ec_mul(f1, bs1, r))
    if poks and not recursion_friendly:
        # fold the PoKs into one as gnark does (prove.go:110-128):
        # challenge = fr.Hash(commitment wire values, "G16-BSB22"),
        # CommitmentPok = sum challenge^i * pok_i
        ch = gnark_fs.groth16_fold_challenge(cm_vals, q)
        acc, cp = host.INF, 1
        for pok in poks:
            acc = host.ec_add(f1, acc, host.ec_mul(f1, pok, cp))
            cp = cp * ch % q
        poks = [acc]
    mark("combine")
    return Proof(ar=ar, krs=krs, bs=bs, commitments=commitments, poks=poks)


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------

def verify(proof: Proof, vk: VerifyingKey, public_values,
           recursion_friendly=False) -> bool:
    """e(Ar, Bs) == e(alpha, beta) * e(kSum, gamma) * e(Krs, delta),
    checked as FE(ML(Krs, -delta) ML(Ar, Bs) ML(kSum, -gamma)) ==
    vk.e_alpha_beta (verify.go:70-143), on the host. Every proof point is
    validated (on the curve, in the subgroup) first; the commitment wire
    values are recomputed from the proof's commitments and extend the
    public vector, and the PoKs are pairing-checked (folded into one
    unless recursion_friendly)."""
    curve = vk.curve
    q = curve.fr.modulus
    nb_cm = len(vk.commitment_g2_sigma)
    if len(proof.commitments) != nb_cm:
        return False
    # gnark proofs carry ONE folded PoK (marshal.go Ar|Bs|Krs|
    # Commitments|CommitmentPok); recursion_friendly proofs keep one per
    # commitment
    if len(proof.poks) != (nb_cm if recursion_friendly else min(nb_cm, 1)):
        return False
    if not host.validate_points(
            curve, g1_points=[proof.ar, proof.krs] + list(proof.commitments)
            + list(proof.poks), g2_points=[proof.bs]):
        return False
    if len(public_values) != len(vk.g1_k) - 1 - nb_cm:
        raise ValueError(f"want {len(vk.g1_k) - 1 - nb_cm} public values, "
                         f"got {len(public_values)}")
    f1 = curve.host_fp
    # the hashed public-committed values resolve against the growing
    # extended vector (verify.go:85-103 solveCommitmentWire)
    extended = [v % q for v in public_values]
    pac = list(vk.commitment_pac or [()] * nb_cm)
    for ci, C in enumerate(proof.commitments):
        pac_vals = [extended[i - 1] for i in pac[ci]]
        extended.append(_hash_to_field(curve, C, recursion_friendly,
                                       public_committed=pac_vals))
    ksum = vk.g1_k[0]
    for v, pt in zip(extended, vk.g1_k[1:]):
        ksum = host.ec_add(f1, ksum, host.ec_mul(f1, pt, v % q))
    for C in proof.commitments:
        ksum = host.ec_add(f1, ksum, C)
    pairing = get_pairing(curve.name)
    f2h = curve.host_g2_field
    if recursion_friendly:
        # per-commitment PoKs: e(pok, g2) == e(C, sigma g2)
        pok_pairs = [pr for C, pok, g2s in
                     zip(proof.commitments, proof.poks,
                         vk.commitment_g2_sigma)
                     for pr in ((pok, host.ec_neg(f2h, curve.g2)),
                                (C, g2s))]
    elif nb_cm:
        # folded check (verify.go:104-113, pedersen.BatchVerifyMultiVk):
        # with gamma the G16-BSB22 challenge over the commitment values,
        # e(-fold(pok), g2) * prod e(gamma^i C_i, sigma_i) == 1
        ch = gnark_fs.groth16_fold_challenge(extended[-nb_cm:], q)
        pok_pairs = [(host.ec_neg(f1, proof.poks[0]), curve.g2)]
        cp = 1
        for C, g2s in zip(proof.commitments, vk.commitment_g2_sigma):
            pok_pairs.append((host.ec_mul(f1, C, cp), g2s))
            cp = cp * ch % q
    else:
        pok_pairs = []
    if pok_pairs and not pairing.ext.eq(pairing.pairing_product(pok_pairs),
                                        pairing.gt_one()):
        return False
    res = pairing.pairing_product([
        (proof.krs, vk.g2_delta_neg),
        (proof.ar, proof.bs),
        (ksum, vk.g2_gamma_neg),
    ])
    return pairing.ext.eq(res, vk.e_alpha_beta)


def _words_from_limbs(a) -> np.ndarray:
    """(..., 2k) 16-bit limbs (the reference's layout) -> (..., k)
    int32 words."""
    a = np.asarray(a).astype(np.uint32)
    return (a[..., 0::2] | (a[..., 1::2] << 16)).view(np.int32)


def proving_key_from_arrays(d: dict, curve: str = "bn254",
                            device=None) -> ProvingKey:
    """Proving key on the device from plain data: d holds domain_n,
    g1_a/g1_b/g1_z/g1_k/g2_b as (x, y, inf) numpy arrays in 16-bit limbs
    ((n, L) over Fp, (n, 2, L) over Fp2, L = 2 nw: 16 on BN254, 48 on
    BW6-761, whose G2 lies over Fp; Montgomery form), host-int
    affine points g1_alpha, g1_beta, g1_delta, g2_beta, g2_delta, and
    optionally commitment_keys: one dict per commitment with wires,
    basis and basis_exp_sigma ((x, y, inf) G1 arrays as above), g2_sigma
    (host point) and nb_public."""
    dev = resolve_device(device)
    c = curves_mod.CURVES[curve]
    check_curve(c, dev)

    def pts(t):
        x, y, inf = t
        return (torch.as_tensor(_words_from_limbs(x), device=dev),
                torch.as_tensor(_words_from_limbs(y), device=dev),
                torch.as_tensor(np.asarray(inf, dtype=bool).reshape(-1),
                                device=dev))

    return ProvingKey(
        curve=c, domain_n=int(d["domain_n"]),
        g1_a=pts(d["g1_a"]), g1_b=pts(d["g1_b"]), g1_z=pts(d["g1_z"]),
        g1_k=pts(d["g1_k"]), g2_b=pts(d["g2_b"]),
        g1_alpha=d["g1_alpha"], g1_beta=d["g1_beta"],
        g1_delta=d["g1_delta"], g2_beta=d["g2_beta"],
        g2_delta=d["g2_delta"],
        commitment_keys=[CommitmentKey(
            wires=tuple(k["wires"]), basis=pts(k["basis"]),
            basis_exp_sigma=pts(k["basis_exp_sigma"]),
            g2_sigma=k["g2_sigma"], nb_public=int(k["nb_public"]))
            for k in d.get("commitment_keys", ())])


def dummy_setup(cs: ConstraintSystem, curve_name: str,
                device=None) -> ProvingKey:
    """Fake ProvingKey for benchmarking the prover (reference
    groth16.DummySetup): every column point is the generator. Proofs
    made with it do NOT verify."""
    dev = resolve_device(device)
    curve = curves_mod.CURVES[curve_name]
    check_curve(curve, dev)
    if curve.fr.modulus != cs.q:
        raise ValueError("constraint system field != curve scalar field")
    nb_wires = cs.nb_wires
    N = _next_pow2(max(cs.nb_constraints, 1))
    ffp = get_ff(curve.fp.name)
    ff2 = _g2_field(curve)

    def tiled(ff, pt, n):
        one = _encode_affine_host(ff, [pt], dev)
        return tuple(a.expand((n,) + a.shape[1:]).contiguous() for a in one)

    g, g2pt = curve.g1, curve.g2
    enc = tiled(ffp, g, nb_wires)
    return ProvingKey(
        curve=curve, domain_n=N,
        g1_a=enc, g1_b=enc, g1_z=tiled(ffp, g, N),
        g1_k=tiled(ffp, g, max(nb_wires - cs.nb_public, 1)),
        g2_b=tiled(ff2, g2pt, nb_wires),
        g1_alpha=g, g1_beta=g, g1_delta=g, g2_beta=g2pt, g2_delta=g2pt)
