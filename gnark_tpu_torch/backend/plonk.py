"""PLONK on the card (BN254, BLS12-381; the other curves on the CPU):
Setup / Prove / Verify, KZG-based, with BSB22 commitments through Qcp
columns.

Counterpart of gnark_tpu.backend.plonk (reference
backend/plonk/bn254/{setup,prove,verify}.go):

  * trace: ql/qr/qm/qo/qk columns with nb_public placeholder rows
    (ql = -1) before the gates; the permutation over 3N slots follows
    each variable's cycle of slots (setup.go buildPermutation);
  * Setup: the trace and the permutation on the host (numpy), the sigma
    evaluations u^k w^j on the card (K12 powers of w, K1), then each
    column's iFFT (K5 / K2) and KZG commitment (bucket MSM) on the card;
    the proving key keeps its columns there;
  * Prove: backend/plonk_device.py (solve on the host, every O(N) step
    on the card);
  * Verify: on the host: recompute the challenges, PI(zeta), the
    constLin check, the linearized digest and two KZG opening checks.

Fiat-Shamir is gnark's by default (gnark_fs: sha256 transcript
"gamma", "beta", "alpha", "zeta"), or the MiMC transcript under
recursion_friendly. The same rng seed as the reference's prove gives the
same PlonkProof. Keys made by the reference come across through
`keys_from_arrays`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnark_tpu_torch.backend import gnark_fs
from gnark_tpu_torch.backend import kzg as kzg_mod
from gnark_tpu_torch.backend.groth16 import _mark_fn, _words_from_limbs
from gnark_tpu_torch.backend.transcript import MimcTranscript
from gnark_tpu_torch.backend.transcript import outer_mimc_field as \
    _outer_mimc_field
from gnark_tpu_torch.constraint import ConstraintSystem
from gnark_tpu_torch.cuda import check_curve, resolve_device
from gnark_tpu_torch.ec import curves as curves_mod
from gnark_tpu_torch.ec import host
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff.mont_mul import mont_mul
from gnark_tpu_torch.logger import get_logger
from gnark_tpu_torch.ntt import get_domain


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n & (n - 1) or n == 0 else n


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlonkVerifyingKey:
    curve: curves_mod.Curve
    size: int                 # N
    generator: int            # omega
    coset_shift: int          # u
    nb_public: int
    s_comm: list              # [S1], [S2], [S3] host G1 points
    ql_c: tuple
    qr_c: tuple
    qm_c: tuple
    qo_c: tuple
    qk_c: tuple               # incomplete qk commitment
    g2_gen: tuple
    g2_tau: tuple
    # BSB22 commitments (reference setup.go:57-62): one Qcp selector
    # digest + the COMMITMENT constraint row index per api.commit
    qcp_c: list = dataclasses.field(default_factory=list)
    commitment_rows: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PlonkProvingKey:
    """Every column is (N, nw) int32 words in Montgomery form on the
    SRS's device (the reference keeps host ints and a device cache)."""
    vk: PlonkVerifyingKey
    srs: kzg_mod.SRS
    ql: torch.Tensor          # Lagrange-basis trace columns
    qr: torch.Tensor
    qm: torch.Tensor
    qo: torch.Tensor
    qk: torch.Tensor          # incomplete
    ql_coeffs: torch.Tensor   # canonical coefficients
    qr_coeffs: torch.Tensor
    qm_coeffs: torch.Tensor
    qo_coeffs: torch.Tensor
    qk_coeffs: torch.Tensor
    s1_coeffs: torch.Tensor
    s2_coeffs: torch.Tensor
    s3_coeffs: torch.Tensor
    s1_vals: torch.Tensor     # sigma evaluations on the domain
    s2_vals: torch.Tensor
    s3_vals: torch.Tensor
    perm: np.ndarray          # the 3N permutation, int64
    wpow: torch.Tensor        # omega^i, i < N
    qcp_coeffs: list = dataclasses.field(default_factory=list)

    @property
    def device(self) -> torch.device:
        return self.ql.device

    def to(self, device) -> "PlonkProvingKey":
        """A copy with every tensor (the SRS's too) on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(
            self, srs=self.srs.to(device),
            qcp_coeffs=[c.to(device) for c in self.qcp_coeffs], **moved)


@dataclasses.dataclass
class PlonkProof:
    lro: list                 # 3 G1 commitments (blinded l, r, o)
    z: tuple                  # commitment to blinded Z
    h: list                   # 3 quotient shard commitments
    batched_h: tuple          # folded opening quotient at zeta
    claimed: list             # [lin(z), l, r, o, s1, s2, qcp_i(z)...]
    z_shift_h: tuple          # opening quotient of Z at omega*zeta
    zu: int                   # Z(omega*zeta)
    bsb22: list = dataclasses.field(default_factory=list)  # pi2 commits


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

def encode_column(ff, vals, device) -> torch.Tensor:
    """Host ints in [0, q) -> (len, nw) Montgomery words on device, one
    encode for each distinct value (trace columns hold few)."""
    index: dict = {}
    idx = np.fromiter((index.setdefault(v, len(index)) for v in vals),
                      dtype=np.int64, count=len(vals))
    table = ff.encode_words(list(index)) if index else \
        np.zeros((0, ff.nw), dtype=np.int32)
    return torch.as_tensor(table[idx], device=device)


def permutation(lro: np.ndarray) -> np.ndarray:
    """setup.go buildPermutation over the 3N slots' wire ids: each slot
    points to the previous slot of its wire, the first to the last."""
    order = np.argsort(lro, kind="stable")
    v = lro[order]
    start = np.ones(len(v), dtype=bool)
    start[1:] = v[1:] != v[:-1]
    firsts = np.flatnonzero(start)
    lasts = np.append(firsts[1:] - 1, len(v) - 1)
    grp = np.cumsum(start) - 1
    perm = np.empty(len(v), dtype=np.int64)
    perm[order] = np.where(start, order[lasts[grp]], np.roll(order, 1))
    return perm


def setup(cs: ConstraintSystem, srs: kzg_mod.SRS,
          timings: dict | None = None):
    """PLONK setup on the SRS's device. Returns (pk, vk), equal to the
    reference's setup on the same circuit and SRS.

    timings: if a dict, filled with seconds per phase (trace: the
    columns and the permutation on the host; encode: their upload;
    sigma: the sigma evaluations; ifft; commit)."""
    from gnark_tpu_torch.backend import plonk_device as pdev
    if cs.kind != "scs":
        raise ValueError("plonk needs an SCS (PLONKish) circuit")
    curve = srs.curve
    q = curve.fr.modulus
    if q != cs.q:
        raise ValueError("constraint system field != curve scalar field")
    dev = srs.device
    check_curve(curve, dev, plonk=True)
    mark = _mark_fn(timings, dev, get_logger("gnark_tpu_torch"),
                    "plonk setup")
    nb_pub = cs.nb_public
    n = len(cs.sparse)
    N = _next_pow2(nb_pub + cs.nb_constraints)
    srs_len = srs.g1_powers[0].shape[0]
    if srs_len < N + 3:
        raise ValueError(f"SRS too small: need {N + 3}, got {srs_len}")
    w = curve.fr.root_of_unity(N)
    u = curve.fr.generator % q
    ffr = get_ff(curve.fr.name)

    # trace columns with placeholder rows (setup.go NewTrace)
    off = nb_pub
    cols = {k: [0] * N for k in ("ql", "qr", "qm", "qo", "qk")}
    cols["ql"][:nb_pub] = [q - 1] * nb_pub
    for k, attr in (("ql", "qL"), ("qr", "qR"), ("qm", "qM"), ("qo", "qO"),
                    ("qk", "qC")):
        cols[k][off:off + n] = [getattr(c, attr) for c in cs.sparse]
    xa, xb, xc = pdev._col_indexes(cs, N)
    perm = permutation(np.concatenate([xa, xb, xc]))
    mark("trace")
    lag = {k: encode_column(ffr, v, dev) for k, v in cols.items()}
    mark("encode")

    # sigma evaluations: slot j encodes u^(j // N) * w^(j % N)
    wpow = pdev.dev_powers(ffr, w, N, dev)
    uk = torch.as_tensor(ffr.encode_words([1, u, u * u % q]), device=dev)
    pt = torch.as_tensor(perm, device=dev)
    sig = mont_mul(ffr, wpow[pt % N], uk[pt // N])
    for i, k in enumerate(("s1", "s2", "s3")):
        lag[k] = sig[i * N:(i + 1) * N]
    mark("sigma")

    dom = get_domain(ffr, N, dev)
    coeffs = {k: dom.ifft(v) for k, v in lag.items()}
    qcp_coeffs = []
    for cm in cs.commitments:
        rows = torch.as_tensor([off + r for r in cm.committed_rows],
                               device=dev)
        qcp_coeffs.append(dom.ifft(pdev.sparse_column(
            ffr, N, rows, [1] * len(cm.committed_rows), dev)))
    mark("ifft")
    comms = {k: pdev.commit_dev(srs, c) for k, c in coeffs.items()}
    qcp_comms = [pdev.commit_dev(srs, c) for c in qcp_coeffs]
    mark("commit")

    vk = PlonkVerifyingKey(
        curve=curve, size=N, generator=w, coset_shift=u, nb_public=nb_pub,
        s_comm=[comms["s1"], comms["s2"], comms["s3"]],
        ql_c=comms["ql"], qr_c=comms["qr"], qm_c=comms["qm"],
        qo_c=comms["qo"], qk_c=comms["qk"],
        g2_gen=srs.g2_gen, g2_tau=srs.g2_tau,
        qcp_c=qcp_comms,
        commitment_rows=[cm.commitment_row for cm in cs.commitments])
    pk = PlonkProvingKey(
        vk=vk, srs=srs, ql=lag["ql"], qr=lag["qr"], qm=lag["qm"],
        qo=lag["qo"], qk=lag["qk"],
        **{f"{k}_coeffs": coeffs[k] for k in
           ("ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3")},
        s1_vals=lag["s1"], s2_vals=lag["s2"], s3_vals=lag["s3"],
        perm=perm, wpow=wpow, qcp_coeffs=qcp_coeffs)
    return pk, vk


def keys_from_arrays(d: dict, curve: str = "bn254", device=None):
    """(pk, vk) on the device from plain data, such as the reference's
    SRS and PLONK keys carry (each column (N, 16) 16-bit limbs in
    Montgomery form):

      d["srs"]: g1_powers ((x, y, inf) limb arrays), g2_gen, g2_tau;
      d["vk"]: the PlonkVerifyingKey fields but curve (ints, host points);
      ql, qr, qm, qo, qk, ql_coeffs .. s3_coeffs, s1_vals .. s3_vals:
        limb arrays; perm: 3N ints; qcp_coeffs: a list of limb arrays."""
    from gnark_tpu_torch.backend import plonk_device as pdev
    dev = resolve_device(device)
    c = curves_mod.CURVES[curve]
    check_curve(c, dev, plonk=True)

    def words(a):
        return torch.as_tensor(_words_from_limbs(a), device=dev)

    s = d["srs"]
    x, y, inf = s["g1_powers"]
    srs = kzg_mod.SRS(
        curve=c, g1_powers=(words(x), words(y), torch.as_tensor(
            np.asarray(inf, dtype=bool).reshape(-1), device=dev)),
        g2_gen=s["g2_gen"], g2_tau=s["g2_tau"])
    vk = PlonkVerifyingKey(curve=c, **d["vk"])
    cols = {k: words(d[k]) for k in
            ("ql", "qr", "qm", "qo", "qk", "s1_vals", "s2_vals", "s3_vals")
            + tuple(f"{k}_coeffs" for k in ("ql", "qr", "qm", "qo", "qk",
                                            "s1", "s2", "s3"))}
    pk = PlonkProvingKey(
        vk=vk, srs=srs, perm=np.asarray(d["perm"], dtype=np.int64),
        wpow=pdev.dev_powers(get_ff(c.fr.name), vk.generator, vk.size, dev),
        qcp_coeffs=[words(a) for a in d.get("qcp_coeffs", ())], **cols)
    return pk, vk


# ---------------------------------------------------------------------------
# transcript binding (shared by prove/verify)
# ---------------------------------------------------------------------------

def _new_transcript(vk: PlonkVerifyingKey, recursion=False,
                    challenge_hash=None):
    """challenge_hash: optional hashlib-style factory replacing sha256
    (reference backend.WithProverChallengeHashFunction /
    ProverConfig.ChallengeHash, backend.go:59-82); prover and verifier
    must agree on it."""
    names = ["gamma", "beta", "alpha", "zeta"]
    if recursion:
        return MimcTranscript(vk.curve.fr.modulus, names,
                              _outer_mimc_field(vk.curve, recursion))
    # default: gnark-bit-exact fiat-shamir (prove.go:217)
    ts = gnark_fs.GnarkTranscript(vk.curve.fr.modulus, names,
                                  challenge_hash)
    ts.point_bytes = lambda P, p_mod, _c=vk.curve: gnark_fs.g1_raw_bytes(
        _c, None if P is host.INF else P)
    return ts


def _bind_public_data(ts, vk: PlonkVerifyingKey, publics):
    p = vk.curve.fp.modulus
    for pt in vk.s_comm:
        ts.bind("gamma", ts.point_bytes(pt, p))
    for pt in (vk.ql_c, vk.qr_c, vk.qm_c, vk.qo_c, vk.qk_c):
        ts.bind("gamma", ts.point_bytes(pt, p))
    for pt in vk.qcp_c:
        ts.bind("gamma", ts.point_bytes(pt, p))
    for v in publics:
        ts.bind("gamma", ts.fe_bytes(v))


def _fold_challenge(vk, digests, zeta, zu, claimed,
                    recursion=False) -> int:
    """KZG batch-fold challenge (gnark kzg.BatchOpenSinglePoint gamma):
    binds the point, the digests and the claimed values, like
    gnark-crypto's deriveGamma."""
    p = vk.curve.fp.modulus
    if recursion:
        ts = MimcTranscript(vk.curve.fr.modulus, ["fold"],
                            _outer_mimc_field(vk.curve, recursion))
        for d in digests:
            ts.bind("fold", ts.point_bytes(d, p))
        ts.bind("fold", ts.fe_bytes(zeta))
        ts.bind("fold", ts.fe_bytes(zu))
        for v in claimed:
            ts.bind("fold", ts.fe_bytes(v))
        return ts.challenge("fold")
    q = vk.curve.fr.modulus
    nb = -(-q.bit_length() // 8)
    return gnark_fs.kzg_fold_challenge(
        vk.curve, q, zeta,
        [None if d is host.INF else d for d in digests], claimed,
        extra=(zu % q).to_bytes(nb, "big"))


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------

def _h2f_bsb22(curve, point, recursion=False) -> int:
    """Commitment challenge from a pi2 commitment. Default: gnark's
    fr/hash_to_field with dst "BSB22-Plonk" over the uncompressed point
    bytes (prove.go:206-207,305-312); recursion: MiMC over the outer
    field."""
    if recursion:
        from gnark_tpu_torch.backend.transcript import mimc_point_writes
        from gnark_tpu_torch.std.hash.mimc import MiMC
        h = MiMC(_outer_mimc_field(curve, recursion))
        h.write(int.from_bytes(b"BSB22-Plonk", "big"))
        h.write(*mimc_point_writes(
            curve, None if point is host.INF else point, recursion))
        mask = (1 << (curve.fr.modulus.bit_length() - 8)) - 1
        return h.sum() & mask
    return gnark_fs.bsb22_plonk_value(
        curve, None if point is host.INF else point, curve.fr.modulus)


def prove(cs: ConstraintSystem, pk: PlonkProvingKey, public, secret,
          rng=None, hint_overrides=None, recursion_friendly=False,
          statistical_zk: bool = False, challenge_hash=None,
          timings: dict | None = None, device=None) -> PlonkProof:
    """PLONK proof of (public, secret) on `device` (None: the card),
    where pk must live (backend/plonk_device.py). rng: a random.Random
    for the blinding factors (default: the secrets module).
    timings: if a dict, filled with seconds per stage."""
    from gnark_tpu_torch.backend import plonk_device
    return plonk_device.prove(
        cs, pk, public, secret, rng=rng, hint_overrides=hint_overrides,
        recursion_friendly=recursion_friendly,
        statistical_zk=statistical_zk, challenge_hash=challenge_hash,
        timings=timings, device=device)


def _lin_digest_prover(pk, vk, c_z, c_h, lz, rz, oz, _s1, coeff_z,
                       zh_zeta, zp2, bsb22_pts=(), qcpz=()):
    """Commitment to the linearized polynomial, computed like the
    verifier does (verify.go:263-280) so both sides agree."""
    q = vk.curve.fr.modulus
    f1 = vk.curve.host_fp
    rl = lz * rz % q
    pts = list(bsb22_pts) + [vk.ql_c, vk.qr_c, vk.qm_c, vk.qo_c, vk.qk_c,
                             vk.s_comm[2], c_z, c_h[0], c_h[1], c_h[2]]
    zh = (q - zh_zeta) % q
    sc = list(qcpz) + [lz, rz, rl, oz, 1, _s1, coeff_z,
                       zh, zh * zp2 % q, zh * zp2 % q * zp2 % q]
    acc = host.INF
    for P, s in zip(pts, sc):
        acc = host.ec_add(f1, acc, host.ec_mul(f1, P, s))
    return acc


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------

def verify(proof: PlonkProof, vk: PlonkVerifyingKey, public_values,
           recursion_friendly=False, challenge_hash=None) -> bool:
    """On the host (verify.go:36-310)."""
    curve = vk.curve
    q = curve.fr.modulus
    N = vk.size
    w = vk.generator
    u = vk.coset_shift
    if len(public_values) != vk.nb_public - 1:
        raise ValueError(f"want {vk.nb_public - 1} public values")
    publics = [1] + [v % q for v in public_values]  # constant-one wire

    # proof shape checks (verify.go:45-59)
    if len(proof.bsb22) != len(vk.qcp_c):
        return False
    if len(proof.claimed) != 6 + len(vk.qcp_c):
        return False
    if not host.validate_points(
            curve,
            g1_points=list(proof.lro) + [proof.z] + list(proof.h)
            + list(proof.bsb22) + [proof.batched_h, proof.z_shift_h]):
        return False
    if any(not isinstance(v, int) or not 0 <= v < q
           for v in list(proof.claimed) + [proof.zu]):
        return False

    ts = _new_transcript(vk, recursion_friendly, challenge_hash)
    _bind_public_data(ts, vk, publics)
    p_mod = curve.fp.modulus
    for pt in proof.lro:
        ts.bind("gamma", ts.point_bytes(pt, p_mod))
    gamma = ts.challenge("gamma")
    beta = ts.challenge("beta")
    for pt in proof.bsb22:
        ts.bind("alpha", ts.point_bytes(pt, p_mod))
    ts.bind("alpha", ts.point_bytes(proof.z, p_mod))
    alpha = ts.challenge("alpha")
    for pt in proof.h:
        ts.bind("zeta", ts.point_bytes(pt, p_mod))
    zeta = ts.challenge("zeta")

    zeta_n = pow(zeta, N, q)
    zh_zeta = (zeta_n - 1) % q
    n_inv = pow(N, -1, q)
    l1_zeta = zh_zeta * pow((zeta - 1) % q, -1, q) % q * n_inv % q

    # PI = sum_i w_i * L_i(zeta)
    pi = 0
    accw = 1
    for v in publics:
        li = zh_zeta * pow((zeta - accw) % q, -1, q) % q * n_inv % q \
            * accw % q
        pi = (pi + li * v) % q
        accw = accw * w % q

    # BSB22: PI += hash(pi2 commitment) * L_{cci}(zeta) (verify.go:162-190)
    for i, cci in enumerate(vk.commitment_rows):
        hashed = _h2f_bsb22(curve, proof.bsb22[i], recursion_friendly)
        wi = pow(w, vk.nb_public + cci, q)
        li = zh_zeta * pow((zeta - wi) % q, -1, q) % q * n_inv % q \
            * wi % q
        pi = (pi + li * hashed) % q

    lin_z, lz, rz, oz, s1z, s2z = proof.claimed[:6]
    qcpz = list(proof.claimed[6:])
    zu = proof.zu
    alpha2 = alpha * alpha % q
    a2l1 = alpha2 * l1_zeta % q

    # constLin check (verify.go:207-223)
    t = (lz + beta * s1z + gamma) % q
    t = t * ((rz + beta * s2z + gamma) % q) % q
    t = t * ((oz + gamma) % q) % q * alpha % q * zu % q
    const_lin = (q - (pi - a2l1 + t) % q) % q
    if lin_z != const_lin:
        return False

    # linearized digest
    t1 = (lz + beta * s1z + gamma) % q
    t2 = (rz + beta * s2z + gamma) % q
    _s1 = alpha * beta % q * t1 % q * t2 % q * zu % q
    idp = (lz + beta * zeta + gamma) % q
    idp = idp * ((rz + beta * u % q * zeta + gamma) % q) % q
    idp = idp * ((oz + beta * u % q * u % q * zeta + gamma) % q) % q
    coeff_z = (a2l1 - alpha * idp) % q
    zp2 = pow(zeta, N + 2, q)

    lin_digest = _lin_digest_prover(None, vk, proof.z, tuple(proof.h),
                                    lz, rz, oz, _s1, coeff_z, zh_zeta, zp2,
                                    proof.bsb22, qcpz)

    digests = [lin_digest] + proof.lro + [vk.s_comm[0], vk.s_comm[1]] \
        + list(vk.qcp_c)
    fold_ch = _fold_challenge(vk, digests, zeta, zu, proof.claimed,
                              recursion_friendly)

    srs_shim = kzg_mod.SRS(curve=curve, g1_powers=None, g2_gen=vk.g2_gen,
                           g2_tau=vk.g2_tau)
    batch = kzg_mod.BatchOpeningProof(h=proof.batched_h,
                                      claimed_values=proof.claimed)
    if not kzg_mod.batch_verify_single_point(srs_shim, digests, batch,
                                             zeta, fold_ch):
        return False
    z_open = kzg_mod.OpeningProof(h=proof.z_shift_h, claimed_value=zu)
    return kzg_mod.verify_opening(srs_shim, proof.z, z_open,
                                  w * zeta % q)
