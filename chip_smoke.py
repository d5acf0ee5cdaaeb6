#!/usr/bin/env python3
"""Smoke test of gnark_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: the four CUDA kernel libraries (one nvcc each, in parallel)
     and the native witness solver;
  3. every kernel against its plain PyTorch version on the card:
     K1 mont_mul, K2 row_fft (and whole four-step transforms), K3
     proj_add / proj_double, K4 bucket_msm, in G1 and G2 with edge cases;
  4. the main path: BN254 Groth16 prove of a 2^20-constraint squaring
     chain (bench.py's g16_20 circuit) on a known-log proving key, three
     times; the five MSMs are checked against one host scalar
     multiplication each, and H by Schwartz-Zippel at a random point;
  5. every kernel again at the shapes the proves give it, held against
     its plain version on the same inputs; its launches during the
     proves, its time, its bound and its plain version's time, as one
     JSON line; then the device as the last line.

Option: --quick stops after phase 3.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

MUL_OPS = {  # 32-bit multiplies per operation (mul.lo + mul.hi per word pair)
    "mul": 264,             # one Montgomery product: 2*64 + 2*64 + 8
    "proj_add": 8 * 264 + 3 * 392,
    "proj_madd": 7 * 264 + 3 * 392,
    "proj_dbl": 9 * 264,
    "proj_add2": 8 * 792 + 3 * 1296,    # G2: Fp2 product = 3 Fp products
    "proj_madd2": 7 * 792 + 3 * 1296,
    "proj_dbl2": 9 * 792,
}
HBM_BYTES_PER_S = 3.35e12
DEV = "cuda"          # the card; a rehearsal may set "cpu"
N_CHAINS, CHAIN_LEN = 2048, 512      # 2^20 constraints


def log(*a):
    print(*a, flush=True)


def timed(fn, reps=5, warm=True):
    """(median milliseconds of fn() over reps runs by CUDA events, after
    one untimed run if warm; the last run's result)."""
    import torch
    if warm:
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), out


def cuda_ms(fn, reps=5):
    return timed(fn, reps)[0]


def int_mul_rate():
    """32-bit integer multiplies per second: SMs x 64 per clock x the
    maximum SM clock nvidia-smi reports."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return sms * 64 * mhz * 1e6


def bound_ms(nbytes, nmul, rate):
    tb, tm = nbytes / HBM_BYTES_PER_S * 1e3, nmul / rate * 1e3
    return (tb, "bytes") if tb >= tm else (tm, "operations")


class Fail(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Fail(what)


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def rand_words(ff, n, rng, lazy=0):
    """n random canonical Montgomery words; the first `lazy` are pushed
    into [p, 2p)."""
    import torch
    q = ff.p.modulus
    vals = [rng.randrange(q) for _ in range(n)]
    raw = [v * ff.p.R_mod % q for v in vals]
    raw = [v + q if i < lazy else v for i, v in enumerate(raw)]
    return torch.as_tensor(ff.encode_words(raw, mont=False), device=DEV)


def proj_err(ff, A, B):
    """Largest canonical-limb difference between the cross products
    X1*Z2 and X2*Z1 (and Y1*Z2, Y2*Z1) of two batches of projective
    points: 0 exactly when each pair is one group element; inf where only
    one of a pair is the identity."""
    import torch
    from gnark_tpu_torch.ec.proj_ec import _limbs
    X1, Y1, Z1 = (_limbs(ff, a) for a in A)
    X2, Y2, Z2 = (_limbs(ff, a) for a in B)
    if not torch.equal(ff.is_zero(Z1), ff.is_zero(Z2)):
        return float("inf")
    return max(max_abs(ff.mul(X1, Z2), ff.mul(X2, Z1)),
               max_abs(ff.mul(Y1, Z2), ff.mul(Y2, Z1)))


def max_abs(a, b):
    import torch
    if a.shape != b.shape:
        return float("inf")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def phase_kernels(rng, res):
    import torch
    from gnark_tpu_torch.backend.groth16 import _proj_to_affine_host
    from gnark_tpu_torch.ec import curves, host
    from gnark_tpu_torch.ec.fp2 import get_ff2
    from gnark_tpu_torch.ec.proj_ec import (proj_add, proj_add_plain,
                                            proj_double, proj_double_plain)
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain
    from gnark_tpu_torch.msm.bucket import (bucket_msm, bucket_msm_plain,
                                            curve_b3, curve_b3_g2,
                                            signed_digits)
    from gnark_tpu_torch.msm.pippenger import scalar_limbs
    from gnark_tpu_torch.ntt import Domain
    from gnark_tpu_torch.ntt.fourstep import dif_stage_tw, row_fft, \
        row_fft_plain

    fr = get_ff("bn254_fr")
    fp = get_ff("bn254_fp")

    # K1: 2^16 elements (some in [p, 2p)), plus a broadcast operand
    err = 0
    for ff in (fr, fp):
        a = rand_words(ff, 1 << 16, rng, lazy=1000)
        b = rand_words(ff, 1 << 16, rng, lazy=1000)
        for bb in (b, b[:1]):
            got, want = mont_mul(ff, a, bb), mont_mul_plain(ff, a, bb)
            check(torch.equal(got, want), f"K1 mont_mul {ff.p.name}")
            err = max(err, max_abs(got, want))
    res["mont_mul"]["max_abs_err"] = err
    log(f"K1 mont_mul: (65536, 8) x (65536|1, 8) fr+fp bit-exact "
        f"{cuda_ms(lambda: mont_mul(fr, a, b)):.4f} ms")

    # K2: rows of 2^10 and 2^9
    err = 0
    for S in (1 << 10, 1 << 9):
        x = rand_words(fr, 8 * S, rng).reshape(8, S, 8)
        tw = torch.as_tensor(dif_stage_tw(fr, S, fr.p.root_of_unity(S)),
                             device=DEV)
        got, want = row_fft(fr, x, tw), row_fft_plain(fr, x, tw)
        check(torch.equal(got, want), f"K2 row_fft S={S}")
        err = max(err, max_abs(got, want))
        log(f"K2 row_fft: (8, {S}, 8) bit-exact "
            f"{cuda_ms(lambda: row_fft(fr, x, tw)):.4f} ms")
    # whole four-step 2^12 transforms against the plain four-step
    n = 1 << 12
    dg, dc = Domain(fr, n, DEV), Domain(fr, n, "cpu")
    x = rand_words(fr, n, rng)
    for name, fg, fc in (
            ("fft", lambda v: dg.fft(v), lambda v: dc.fft(v)),
            ("ifft", lambda v: dg.ifft(v), lambda v: dc.ifft(v)),
            ("coset fft", lambda v: dg.fft(v, coset=True),
             lambda v: dc.fft(v, coset=True)),
            ("coset ifft", lambda v: dg.ifft(v, coset=True),
             lambda v: dc.ifft(v, coset=True))):
        got, want = fg(x).cpu(), fc(x.cpu())
        check(torch.equal(got, want), f"four-step 2^12 {name}")
        err = max(err, max_abs(got, want))
    res["row_fft"]["max_abs_err"] = err
    log("K2 four-step 2^12 fft/ifft/coset fft/coset ifft bit-exact")

    # K3 and K4 in G1 and G2
    c = curves.CURVES["bn254"]
    err3 = {"proj_add": 0, "proj_double": 0}
    for g2 in (False, True):
        ff = get_ff2(c.fp.name, c.fp2_nr) if g2 else fp
        hf = c.host_g2_field if g2 else c.host_fp
        b3 = curve_b3_g2(c.fp.name) if g2 else curve_b3(c.fp.name)
        gen = c.g2 if g2 else c.g1
        tag = "G2" if g2 else "G1"
        # 64 distinct points, tiled to 2^12 pairs with random Z
        base = [gen]
        for _ in range(63):
            base.append(host.ec_add(hf, base[-1], gen))
        n = 1 << 12
        P = [base[rng.randrange(64)] for _ in range(n)]
        Q = [base[rng.randrange(64)] for _ in range(n)]
        P[0] = host.INF                           # identity + Q
        Q[1] = host.INF                           # P + identity
        Q[2] = P[2]                               # P + P
        Q[3] = host.ec_neg(hf, P[3])              # P + (-P)
        P[4] = Q[4] = host.INF
        lazy = 200                                # first coords in [p, 2p)
        A = proj_words(ff, hf, P, rng, g2, lazy)
        B = proj_words(ff, hf, Q, rng, g2, 0)
        got, want = proj_add(ff, b3, A, B), proj_add_plain(ff, b3, A, B)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"K3 proj_add {tag}")
        err3["proj_add"] = max([err3["proj_add"]] +
                               [max_abs(u, v) for u, v in zip(got, want)])
        for i in range(8):
            R = _proj_to_affine_host(ff, hf, tuple(a[i:i + 1] for a in got))
            check(R == host.ec_add(hf, P[i], Q[i]),
                  f"K3 proj_add {tag} vs host at {i}")
        got = proj_double(ff, b3, A)
        want = proj_double_plain(ff, b3, A)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"K3 proj_double {tag}")
        err3["proj_double"] = max([err3["proj_double"]] +
                                  [max_abs(u, v) for u, v in zip(got, want)])
        log(f"K3 proj_add/proj_double {tag}: ({n}, {A[0].shape[1]}) "
            f"bit-exact, host-checked; add "
            f"{cuda_ms(lambda: proj_add(ff, b3, A, B)):.4f} ms, double "
            f"{cuda_ms(lambda: proj_double(ff, b3, A)):.4f} ms")

        # K4: 2^12 points with infinity points, zero scalars, duplicates
        pts = [base[rng.randrange(64)] for _ in range(n)]
        ks = [rng.randrange(c.fr.modulus) for _ in range(n)]
        inf = torch.zeros(n, dtype=torch.bool, device=DEV)
        inf[5:9] = True
        for i in range(10, 20):
            ks[i] = 0
        for i in range(20, 40):
            ks[i] = 1                               # skew: bucket 0
        x, y = affine_words(ff, pts)
        digits = signed_digits(scalar_limbs(torch.as_tensor(
            fr.encode_words(ks, mont=False), device=DEV)), 254, 8)
        got = bucket_msm(ff, b3, x, y, inf, digits)
        want = bucket_msm_plain(ff, b3, x, y, inf, digits)
        err = proj_err(ff, got, want)
        check(err == 0, f"K4 bucket_msm {tag}")
        res["bucket_msm"]["max_abs_err"] = max(
            res["bucket_msm"]["max_abs_err"] or 0, err)
        log(f"K4 bucket_msm {tag}: ({n}, {x.shape[1]}) points, digits "
            f"{tuple(digits.shape)}, equal as group elements; "
            f"{cuda_ms(lambda: bucket_msm(ff, b3, x, y, inf, digits)):.4f}"
            f" ms")
    for k, v in err3.items():
        res[k]["max_abs_err"] = v


def proj_words(ff, hf, pts, rng, g2, lazy):
    """Host affine points -> random-Z projective words on the card; the
    first `lazy` X coordinates are pushed into [p, 2p)."""
    import torch
    from gnark_tpu_torch.ec import host
    q = ff.p.modulus
    X, Y, Z = [], [], []
    for P in pts:
        if P is host.INF:
            X.append((0, 0) if g2 else 0)
            Y.append((1, 0) if g2 else 1)
            Z.append((0, 0) if g2 else 0)
            continue
        z = rng.randrange(1, q)
        zz = (z, 0) if g2 else z
        X.append(hf.mul(P[0], zz))
        Y.append(hf.mul(P[1], zz))
        Z.append(zz)
    n = len(pts)
    base = ff.base if g2 else ff
    out = []
    for vals in (X, Y, Z):
        flat = [v for t in vals for v in t] if g2 else vals
        mont = [v * base.p.R_mod % q for v in flat]
        if vals is X:
            k = 2 if g2 else 1
            mont = [v + q if i < lazy * k else v for i, v in enumerate(mont)]
        out.append(torch.as_tensor(base.encode_words(mont, mont=False),
                                   device=DEV).reshape(n, -1))
    return tuple(out)


def affine_words(ff, pts):
    """Host affine points -> (x, y) flat (n, Lw) words on the device."""
    import torch
    n = len(pts)
    return tuple(torch.as_tensor(ff.encode_words([p[i] for p in pts]),
                                 device=DEV).reshape(n, -1) for i in (0, 1))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_main(res):
    from gnark_tpu_torch import native
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.backend.groth16_check import (CheckError,
                                                       check_prove,
                                                       known_log_key,
                                                       synth_square_chain)
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ec.proj_ec import proj_add, proj_double
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ff.mont_mul import mont_mul
    from gnark_tpu_torch.msm.bucket import bucket_msm
    from gnark_tpu_torch.ntt import get_domain
    from gnark_tpu_torch.ntt.fourstep import row_fft

    t = time.perf_counter()
    cs = synth_square_chain(N_CHAINS, CHAIN_LEN)
    curve = curves.CURVES["bn254"]
    log(f"main path: circuit {cs.summary()} built in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    pk = known_log_key(cs, curve, DEV)
    sync()
    log(f"main path: known-log key (N = {pk.domain_n}) on the device in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    get_domain(get_ff("bn254_fr"), pk.domain_n, DEV)
    native._lib()
    sync()
    log(f"main path: domain tables and solver load in "
        f"{time.perf_counter() - t:.2f} s")

    wrappers = (mont_mul, row_fft, proj_add, proj_double, bucket_msm)
    for wr in wrappers:
        wr.launches = 0
    for i in range(3):
        sec = [(i * 7919 + j + 2) for j in range(N_CHAINS)]
        tm = {}
        t = time.perf_counter()
        proof = groth16.prove(cs, pk, [], sec, rng=random.Random(100 + i),
                              timings=tm)
        tm["total"] = time.perf_counter() - t
        check(None not in (proof.ar, proof.krs, proof.bs),
              "prove returned an identity point")
        log("prove %d (s): %s" % (i, json.dumps(
            {k: round(v, 4) for k, v in tm.items()})))
    launches = {wr.__name__: wr.launches for wr in wrappers}
    log("launches during 3 proves: " + json.dumps(launches))
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
        res[k]["launches"] = v
    t = time.perf_counter()
    try:
        check_prove(cs, pk, [], [j + 2 for j in range(N_CHAINS)],
                    random.Random(7))
    except CheckError as e:
        raise Fail(str(e))
    log("main path: the five MSMs equal their known-log values and "
        "A(tau)B(tau) - C(tau) == H(tau)(tau^N - 1) "
        f"(checked in {time.perf_counter() - t:.1f} s)")
    return pk.g1_a[0].shape[0]


def sync():
    import torch
    if DEV != "cpu":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 5: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def phase_times(res, rng, n_pts, n=1 << 20):
    """Each kernel at the shapes the main path gives it (a domain of n,
    n_pts points for K4): timed, and held against its plain version on the same
    inputs; a disagreement fails the run."""
    import torch
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ec.fp2 import get_ff2
    from gnark_tpu_torch.ec.proj_ec import (proj_add, proj_add_plain,
                                            proj_double, proj_double_plain)
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain
    from gnark_tpu_torch.msm.bucket import (BUCKETS, bucket_msm,
                                            bucket_msm_plain, curve_b3,
                                            curve_b3_g2, group_pairs,
                                            signed_digits)
    from gnark_tpu_torch.msm.pippenger import scalar_limbs
    from gnark_tpu_torch.ntt.fourstep import (dif_stage_tw, row_fft,
                                              row_fft_plain)
    rate = int_mul_rate()
    fr = get_ff("bn254_fr")
    c = curves.CURVES["bn254"]

    def put(name, sfx, shape, ms, plain_ms, nbytes, nmul, err,
            plain_shape=None):
        """Record one shape of a kernel; keys of a second shape carry
        the suffix sfx."""
        check(err == 0, f"{name} {shape} disagrees with its plain version "
              f"(max abs err {err})")
        b, by = bound_ms(nbytes, nmul, rate)
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"] or 0, err)
        r.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                  "bound_ms" + sfx: b, "bound_by" + sfx: by,
                  "shape" + sfx: shape})
        if plain_shape:
            r["plain_shape" + sfx] = plain_shape
        log(f"{name} {shape}: {ms:.4f} ms, plain {plain_shape or shape} "
            f"{plain_ms:.3f} ms, bound {b:.4f} ms ({by}), agree")

    a, b = rand_words(fr, n, rng), rand_words(fr, n, rng)
    ms, got = timed(lambda: mont_mul(fr, a, b))
    pms, want = timed(lambda: mont_mul_plain(fr, a, b), 3)
    put("mont_mul", "", [n, 8], ms, pms, 3 * n * 32, n * MUL_OPS["mul"],
        max_abs(got, want))
    del a, b, got, want
    S = 1 << (n.bit_length() // 2)                 # row length, as FourStep
    x = rand_words(fr, n, rng).reshape(n // S, S, 8)
    tw = torch.as_tensor(dif_stage_tw(fr, S, fr.p.root_of_unity(S)),
                         device=DEV)
    ms, got = timed(lambda: row_fft(fr, x, tw))
    pms, want = timed(lambda: row_fft_plain(fr, x, tw), 3)
    put("row_fft", "", [n // S, S, 8], ms, pms,
        2 * n * 32 + tw.numel() * 4,
        n // 2 * (S.bit_length() - 1) * MUL_OPS["mul"], max_abs(got, want))
    del x, got, want
    # K3: the epilogue's widest scan step (W * B/2 pairs, W = 32 windows)
    # and its one-point Horner adds and doubles
    fp = get_ff("bn254_fp")
    b3 = curve_b3(c.fp.name)
    wide = 32 * BUCKETS // 2
    for name, sfx, w, fn, pfn, k, nin in (
            ("proj_add", "", wide, proj_add, proj_add_plain, "proj_add", 6),
            ("proj_add", "_1", 1, proj_add, proj_add_plain, "proj_add", 6),
            ("proj_double", "", 1, proj_double, proj_double_plain,
             "proj_dbl", 3)):
        P = tuple(rand_words(fp, w, rng, lazy=w // 4) for _ in range(nin))
        args = (P[:3], P[3:]) if nin == 6 else (P,)
        ms, got = timed(lambda: fn(fp, b3, *args))
        pms, want = timed(lambda: pfn(fp, b3, *args), 3)
        put(name, sfx, [w, 8], ms, pms, (nin + 3) * w * 32, w * MUL_OPS[k],
            max(max_abs(u, v) for u, v in zip(got, want)))
    # K4 at the main path's MSM size, G1 and G2
    from gnark_tpu_torch.ec import host
    ks = torch.as_tensor(fr.encode_words(
        [rng.randrange(c.fr.modulus) for _ in range(4096)], mont=False),
        device=DEV)
    idx = torch.randint(0, 4096, (n_pts,), device=DEV)
    digits = signed_digits(scalar_limbs(ks[idx]), 254, 8)
    inf = torch.zeros(n_pts, dtype=torch.bool, device=DEV)
    W = digits.shape[0]
    ent, ss, sl, so = group_pairs(digits, inf)
    pairs, nseg = ent.numel(), ss.numel()
    for g2 in (False, True):
        ff = get_ff2(c.fp.name, c.fp2_nr) if g2 else fp
        hf = c.host_g2_field if g2 else c.host_fp
        gen = c.g2 if g2 else c.g1
        bb = curve_b3_g2(c.fp.name) if g2 else b3
        base = [gen]
        for _ in range(255):
            base.append(host.ec_add(hf, base[-1], gen))
        x0, y0 = affine_words(ff, base)
        pidx = torch.randint(0, 256, (n_pts,), device=DEV)
        x, y = x0[pidx].contiguous(), y0[pidx].contiguous()
        Lw = x.shape[1]
        ms, got = timed(lambda: bucket_msm(ff, bb, x, y, inf, digits))
        op = "2" if g2 else ""
        nmul = (pairs - nseg) * MUL_OPS["proj_madd" + op] + \
            nseg * MUL_OPS["proj_add" + op]
        nbytes = n_pts * 2 * Lw * 4 + pairs * 4 + nseg * 8 + \
            (W * BUCKETS + 1) * 4 + W * BUCKETS * 3 * Lw * 4 + W * n_pts * 4
        # G2's plain version at full size takes minutes: it runs on the
        # first 2^16 points, against the kernel on the same slice
        pn = min(1 << 16, n_pts) if g2 else n_pts
        sl_ = (x[:pn], y[:pn], inf[:pn], digits[:, :pn])
        pms, want = timed(lambda: bucket_msm_plain(ff, bb, *sl_), 1,
                          warm=False)
        if g2:
            got = bucket_msm(ff, bb, *sl_)
        put("bucket_msm", "_g2" if g2 else "", [n_pts, Lw], ms, pms, nbytes,
            nmul, proj_err(ff, got, want), plain_shape=[pn, Lw])


# ---------------------------------------------------------------------------

KERNELS = {
    "mont_mul": ("gnark_tpu_torch/csrc/mont_mul.cu",
                 "gnark_tpu/ff/pallas_ops.py:34 mul_p; "
                 "gnark_tpu/ntt/fourstep.py:198 _mid_mul"),
    "row_fft": ("gnark_tpu_torch/csrc/row_fft.cu",
                "gnark_tpu/ntt/fourstep.py:114 _row_fft"),
    "proj_add": ("gnark_tpu_torch/csrc/proj_ec.cu",
                 "gnark_tpu/ec/pallas_ec.py:316 proj_add_p"),
    "proj_double": ("gnark_tpu_torch/csrc/proj_ec.cu",
                    "gnark_tpu/ec/pallas_ec.py:346 proj_double_p"),
    "bucket_msm": ("gnark_tpu_torch/csrc/bucket_msm.cu",
                   "gnark_tpu/msm/bucket_kernel.py:304 _msm_device "
                   "(_accumulate_kernel:200)"),
}


def main(argv) -> int:
    quick = "--quick" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "gnark_tpu_torch")):
        print("chip_smoke: gnark_tpu_torch/ is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        name = torch.cuda.get_device_name(0)
        log(f"device: {name}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")

        from gnark_tpu_torch import cuda, native
        t = time.perf_counter()
        built = cuda.build_all()
        for k, (sec, out) in built.items():
            log(f"build {k}: {sec:.1f} s")
            for line in out.splitlines():
                if "registers" in line or "spill" in line:
                    log("  " + line.strip())
        t1 = time.perf_counter()
        native._lib()
        log(f"build native solver: {time.perf_counter() - t1:.1f} s; "
            f"all builds {time.perf_counter() - t:.1f} s")

        res = {k: {"name": k, "route": "cuda", "source": s, "replaces": r,
                   "launches": 0, "max_abs_err": None, "ms": None,
                   "plain_ms": None, "bound_ms": None, "bound_by": None,
                   "library_ms": None}
               for k, (s, r) in KERNELS.items()}
        rng = random.Random(2024)
        phase_kernels(rng, res)
        if quick:
            log(json.dumps({"kernels": list(res.values())}))
            log(smi)
            return 0
        n_pts = phase_main(res)
        phase_times(res, rng, n_pts)
        torch.cuda.synchronize()
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": list(res.values())}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
