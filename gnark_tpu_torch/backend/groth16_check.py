"""Checks of a Groth16 prove that need no trusted setup.

A known-log proving key holds in column j the point k_j * G with
k_j = (j + offset) % 4096 + 1 (4096 distinct multiples from a chain of
host additions, tiled), so every MSM of the prove has a known result:
(sum_j k_j * s_j mod r) * G, one host scalar multiplication. A key from
`groth16.setup` has known logs too, the setup's scalars (`setup_logs`). The
quotient H is checked by Schwartz-Zippel at a random point tau:
A(tau) * B(tau) - C(tau) == H(tau) * (tau^N - 1), with A, B, C
evaluated from the solver's columns by the barycentric formula.

`synth_square_chain` builds the prove benchmark's circuit (independent
squaring chains) directly in the IR; `Membership` is the Merkle
membership circuit of examples/merkle_membership.py at any depth;
`RangeChecked` range-checks secret 64-bit values through the shared
lookup table of std/rangecheck, which makes one BSB22 commitment. For
PLONK: `plonk_square_chain` builds the PLONK benchmark's SCS circuit
in the IR, `MimcPreimage` is examples/mimc_plonk.py's circuit and
`Cubic` examples/cubic.py's.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from gnark_tpu_torch import fields
from gnark_tpu_torch.backend import groth16
from gnark_tpu_torch.constraint import solve_auto
from gnark_tpu_torch.constraint.system import (ConstraintSystem,
                                               Instruction, R1C, SparseR1C)
from gnark_tpu_torch.std.hash.mimc import MiMCGadget
from gnark_tpu_torch.ec import host
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.frontend import Circuit, Public, Secret
from gnark_tpu_torch.std import merkle, rangecheck
from gnark_tpu_torch.std.hash.mimc import mimc_hash

TABLE = 4096
OFFSETS = {"g1_a": 0, "g1_b": 1000, "g1_z": 2000, "g1_k": 3000,
           "g2_b": 500}
KNOWN = {"alpha": 11, "beta": 13, "delta": 17}


class CheckError(AssertionError):
    pass


def synth_square_chain(n_chains: int, chain_len: int,
                       field=fields.BN254_FR) -> ConstraintSystem:
    """n_chains independent squaring chains of chain_len constraints
    over `field` (a curve's scalar field)."""
    cs = ConstraintSystem(field, "r1cs")
    cs.secret_names = [f"x{i}" for i in range(n_chains)]
    for ch in range(n_chains):
        w = 1 + ch
        for _ in range(chain_len):
            o = cs.new_internal_wire()
            cs.r1cs.append(R1C(((1, w),), ((1, w),), ((1, o),)))
            cs.add_instruction(
                Instruction(kind="r1c", cidx=len(cs.r1cs) - 1,
                            outputs=(o,)), [w])
            w = o
    return cs


def plonk_square_chain(n_chains: int, chain_len: int,
                       field=fields.BN254_FR) -> ConstraintSystem:
    """bench.py _secondary_plonk18's SCS circuit at any width over
    `field`: n_chains squaring chains (x * x - o == 0) of chain_len
    gates, the last one gate short, so that with the constant-one wire's
    public row N = n_chains * chain_len."""
    q = field.modulus
    cs = ConstraintSystem(field, "scs")
    cs.secret_names = [f"x{i}" for i in range(n_chains)]
    for c in range(n_chains):
        w = 1 + c
        for _ in range(chain_len - (c == n_chains - 1)):
            o = cs.new_internal_wire()
            cs.sparse.append(SparseR1C(w, w, o, 0, 0, q - 1, 1, 0))
            cs.add_instruction(
                Instruction(kind="scs", cidx=len(cs.sparse) - 1,
                            outputs=(o,)), [w])
            w = o
    return cs


class Cubic(Circuit):
    """examples/cubic.py's circuit: x^3 + x + 5 == y."""
    x: Secret
    y: Public

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


class MimcPreimage(Circuit):
    """examples/mimc_plonk.py's circuit: MiMC(pre) == h."""
    pre: Secret
    h: Public

    def define(self, api):
        g = MiMCGadget(api)
        g.write(self.pre)
        api.assert_is_equal(g.sum(), self.h)


class Membership(Circuit):
    """examples/merkle_membership.py's circuit: `leaf`, at the position
    given by the bits `dirs`, hashes up through `path` to the public
    `root` (MiMC over BN254 fr); the depth is len(path)."""
    root: Public
    leaf: Secret
    path: list[Secret]
    dirs: list[Secret]

    def __init__(self, depth: int, **kw):
        self.path = [None] * depth
        self.dirs = [None] * depth
        super().__init__(**kw)

    def define(self, api):
        merkle.verify_proof(api, self.root, self.leaf, self.path, self.dirs)


class RangeChecked(Circuit):
    """n secret values, each checked < 2^64 by
    rangecheck.checker(api).check (gnark's std/rangecheck commit path:
    one identity table, one log-derivative argument, one commitment over
    the queries and the multiplicities)."""
    xs: list[Secret]

    def __init__(self, n: int, **kw):
        self.xs = [None] * n
        super().__init__(**kw)

    def define(self, api):
        rc = rangecheck.checker(api)
        for v in self.xs:
            rc.check(v, 64)


def range_checked_assignment(n: int, seed: int) -> RangeChecked:
    """n random 64-bit values from random.Random(seed)."""
    rng = random.Random(seed)
    c = RangeChecked(n)
    c.xs = [rng.getrandbits(64) for _ in range(n)]
    return c


def membership_assignment(depth: int, index: int) -> Membership:
    """The example's tree (leaves MiMC(i + 1000)) and leaf `index`."""
    leaves = [mimc_hash([i + 1000]) for i in range(1 << depth)]
    root, proof = merkle.host_merkle_root(leaves)
    c = Membership(depth, root=root, leaf=leaves[index])
    c.path, c.dirs = proof(index)
    return c


def known_log_key(cs, curve, device=None) -> groth16.ProvingKey:
    """Proving key of known discrete logs, through
    groth16.proving_key_from_arrays."""
    fp = get_ff(curve.fp.name)
    ff2 = groth16._g2_field(curve)
    f1, f2 = curve.host_fp, curve.host_g2_field
    t1, t2 = [curve.g1], [curve.g2]
    for _ in range(TABLE - 1):
        t1.append(host.ec_add(f1, t1[-1], curve.g1))
        t2.append(host.ec_add(f2, t2[-1], curve.g2))
    enc1 = [fp.encode([p[0] for p in t1]), fp.encode([p[1] for p in t1])]
    enc2 = [ff2.encode([p[0] for p in t2]), ff2.encode([p[1] for p in t2])]
    N = groth16._next_pow2(max(cs.nb_constraints, 1))
    sizes = {"g1_a": cs.nb_wires, "g1_b": cs.nb_wires, "g1_z": N,
             "g1_k": cs.nb_wires - cs.nb_public, "g2_b": cs.nb_wires}
    d = {"domain_n": N}
    for k, n in sizes.items():
        idx = (np.arange(n) + OFFSETS[k]) % TABLE
        enc = enc2 if k == "g2_b" else enc1
        d[k] = (enc[0][idx], enc[1][idx], np.zeros(n, dtype=bool))
    for nm, m in KNOWN.items():
        d["g1_" + nm] = host.ec_mul(f1, curve.g1, m)
    for nm in ("beta", "delta"):
        d["g2_" + nm] = host.ec_mul(f2, curve.g2, KNOWN[nm])
    return groth16.proving_key_from_arrays(d, curve.name, device)


def _known_sum(vals, offset, q):
    s = 0
    for j, v in enumerate(vals):
        s += ((j + offset) % TABLE + 1) * v
    return s % q


def setup_logs(cs, s: dict) -> dict:
    """The discrete logs of the key columns that groth16.setup made from
    the scalars s (groth16.setup_scalars under the same seed): column
    name -> (logs, offset 0), check_prove's `logs`."""
    nw, npub, N = cs.nb_wires, cs.nb_public, s["N"]
    o_z = 3 + 2 * nw
    o_vk = o_z + N
    g1 = s["g1"]
    return {"g1_a": g1[3:3 + nw], "g1_b": g1[3 + nw:3 + 2 * nw],
            "g1_z": g1[o_z:o_z + N], "g1_k": g1[o_vk + npub:o_vk + nw],
            "g2_b": s["g2"][3:3 + nw]}


def _log_sum(vals, logs, q):
    return sum(k * v for k, v in zip(logs, vals)) % q


def check_prove(cs, pk, public, secret, rng, logs=None) -> None:
    """Run prove's own stage functions on the solver's output for
    (public, secret) and check the five MSMs against their known-log
    values (logs: a key's column logs, setup_logs; None: the known-log
    key's) and H by Schwartz-Zippel. Raises CheckError."""
    curve = pk.curve
    q = curve.fr.modulus
    N = pk.domain_n
    sol = solve_auto(cs, public, secret)
    nl = (curve.fr.bits + 63) // 64
    abc = np.zeros((3, N, nl), dtype=np.uint64)
    abc[:, :len(sol.a)] = sol.abc_u64
    abc_raw = groth16._words_u64(abc, pk.device)
    wire_raw = groth16._words_u64(sol.values_u64, pk.device)
    fr = get_ff(curve.fr.name)
    den = pow(pow(curve.fr.generator, N, q) - 1, -1, q)
    den_m = torch.as_tensor(fr.encode_words([den]), device=pk.device)
    g1 = groth16._g1_stage_fn(curve.name, N, cs.nb_public, curve.fr.bits,
                              str(pk.device))
    (ar, bs1, krs2, krs), h = g1(abc_raw, wire_raw, den_m, pk.g1_a,
                                 pk.g1_b, pk.g1_z, pk.g1_k)
    bs2 = groth16._g2_stage_fn(curve.name, curve.fr.bits)(pk.g2_b, wire_raw)
    vals = sol.values
    hv = [int(v) for v in fr.decode_words(h.cpu(), mont=False)]
    f1, f2 = curve.host_fp, curve.host_g2_field
    nb_pub = cs.nb_public

    def ksum(vals, col):
        return _known_sum(vals, OFFSETS[col], q) if logs is None else \
            _log_sum(vals, logs[col], q)

    want = {
        "Ar": (ar, f1, curve.g1, ksum(vals, "g1_a")),
        "Bs1": (bs1, f1, curve.g1, ksum(vals, "g1_b")),
        "Krs2": (krs2, f1, curve.g1, ksum(hv[:N - 1], "g1_z")),
        "Krs": (krs, f1, curve.g1, ksum(vals[nb_pub:], "g1_k")),
        "Bs2": (bs2, f2, curve.g2, ksum(vals, "g2_b")),
    }
    for name, (got, f, g, k) in want.items():
        if got != host.ec_mul(f, g, k):
            raise CheckError(f"MSM {name} differs from its known-log value")

    tau = rng.randrange(2, q)
    w = curve.fr.root_of_unity(N)
    wpows, dens, wi = [], [], 1
    for _ in range(len(sol.a)):
        wpows.append(wi)
        dens.append((tau - wi) % q)
        wi = wi * w % q
    inv = groth16._batch_inv(dens, q)
    zt = (pow(tau, N, q) - 1) % q
    scale = zt * pow(N, -1, q) % q
    ev = []
    for col in (sol.a, sol.b, sol.c):
        s = 0
        for v, wp, iv in zip(col, wpows, inv):
            if v:
                s += v * wp % q * iv
        ev.append(s * scale % q)
    ht = 0
    for c in reversed(hv):
        ht = (ht * tau + c) % q
    if (ev[0] * ev[1] - ev[2]) % q != ht * zt % q:
        raise CheckError("H fails A(tau)B(tau) - C(tau) == "
                         "H(tau)(tau^N - 1)")
