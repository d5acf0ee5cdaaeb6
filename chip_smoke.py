"""Smoke test of gnark_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernel libraries, one nvcc each, in parallel: the
     ten sources for BN254 (8 words, the lazy class), for BLS12-381
     the point sources at 12 words and the scalar-field sources in the
     sound class, for BLS12-377 the point sources at 12 words with u^2 =
     -5 (its scalar field runs BN254's builds), for BW6-761 the point
     sources at 24 words with no Fp2 and 12-word scalars and its scalar
     field's Groth16 sources at 12 words (cuda.builds(): 35 libraries),
     the other curves' niced (BW6-761's started first), each library
     put in place as its nvcc ends (the other curves' by a thread
     each) for the checks processes, which start with the builds and
     wait for their libraries, with each library's seconds and its
     ptxas register / spill lines; and the native witness solver;
  3. every kernel against its plain PyTorch version on the card, in a
     checks process of its own for each curve (curve_checks), BN254's
     too, beside BN254's phases 4 and 5 (their host-bound solves and
     circuits), each waited for before its curve's phase 5 (BN254's
     before its phase 6):
     K1 mont_mul, mont_mul_sub_mul ((a*b - c)*d, broadcast d) and
     affine_words (Jacobian -> affine in G1 and G2: infinity, Z = 1, Z in
     [p, 2p)), K2 row_fft (rows of 2^9 to 2^13: the last past a block's
     shared memory) and whole four-step transforms (fourstep_ntt: two
     launches with the coset / n^-1 scalings and the mid twiddle inside,
     at 2^11-2^13, and with global passes at a lowered cap; the
     segment block's shared-memory size against the host's copy), K3
     proj_add / proj_double, K4 bucket_msm (at c = 8 and at the main
     path's width; its digit kernel at every width) and K9
     bucket_reduce (on K4's sums, all buckets empty, one bucket a
     window, full buckets with equal neighbours and lazy inputs), in G1
     and G2 with edge cases; K5 radix2_ntt (whole transforms at every n
     from 2^1 to 2^13, forward and inverse, in at most two launches; its
     one-stage helper on every stage of 2^13), K6 jac_add_mixed / K7
     jac_double / K8 jac_add (G2 on lane pairs) in G1 and G2 with edge
     cases, K8's group fold jac_fold against its twin, the halving tree
     and the host, and the fused fixed-base ladder at 254 bits on the scalars
     that take the complete add's branches (0, 1, r - 1, r, r + 2);
     K10 ff_addsub, K11 batch_inv, K12 scan_mul and K13 dot (PLONK's
     field operations) at n = 1, 5, 2049, 2^16 and 2^20 on lazy inputs
     with zeros (K11 also on all zeros, a tile of zeros, one nonzero row,
     either side of its tiles and at 2^21; K12 with a zero inside,
     either side of its tile and up to 2^24 + 3 rows: the look-back
     across 2,049 tiles); K13 dot and dot_many (one launch for up to
     eight columns) at n = 1, 256, 257 and 2^18 + 1 with 1, 5 and 9
     columns of unequal lengths; K14 plonk_numerator (the PLONK
     quotient's numerator in one launch) at n = 1, 255, 256, 257 and 2^16
     + 3 in both forms (one Z_H, a period-4 table), against its plain
     version and against the K1 / K10 / K11 sequence it replaced; and the
     CUDA kernels one call of each starts (the profiler's device trace,
     in a fresh process, after sessions thrown away until one sees its
     call's kernels; a call whose trace is empty though its wrapper
     counted a launch is traced again, up to TRACE_TRIES times: K11 3, K12 1,
     K13 1, K14 1); then all of this
     phase again for each curve of CURVES2, before its phase 5: on the
     BLS12-381 builds, 12-word G1 and G2 for K1's affine kernel, K3, K4
     and its digit kernel (255-bit scalars), K6-K9, jac_fold and the
     ladder on 0, 1, r - 1, r, r + 2 at 255 bits; the scalar field's
     sound class for K1, K2, K5 and K10-K14, every operand list holding
     rows in [p, 2p) and a row with both operands at 2p - 1; on
     BLS12-377's, the same point kernels at 12 words with u^2 = -5
     (253-bit scalars), and its scalar field on BN254's builds at n <=
     2^16 + 3 (SHARED_FR; no kernels-a-call trace: BN254's binaries);
     on BW6-761's, its 24-word point kernels (G2 over Fp
     through the G1 kernels with G2's b3 = 12) with 377-bit scalars, the
     ladder on 64 scalars, the affine kernel on 256 points, its 12-word
     scalar field's K1, K2 (rows of 2^13: a global pass, then 2^11
     segments, 2^12 not fitting a block) and K5, no K10-K14 (GROTH16_ONLY:
     K11's inverse takes 8 words), and a PLONK request on the card
     refused before any launch (plonk_refused);
  4. the prove path: BN254 Groth16 prove of a 2^20-constraint squaring
     chain (bench.py's g16_20 circuit) on a known-log proving key, three
     times; each MSM runs the digit kernel, K4 and K9 once and K3 not
     at all, each computeH mont_mul_sub_mul once, 14 K2 launches (seven
     transforms) and 4 K1; the five MSMs are
     checked against one host scalar multiplication each, and H by
     Schwartz-Zippel at a random point;
     (the scan-path MSM, K6, jac_fold, K8 and K7 with no K4 or K9, is
     driven by merkle_d12's third prove: on this circuit it took ~25 s
     of the time limit);
  5. the setup -> prove -> verify path, in three configurations:
     g16_20 (Setup at 2^20: one ladder launch and one affine_words
     launch a group, no K6, K7 or mont_mul; sampled key points against
     host scalar multiplications of the toxic waste, one proof that
     verifies, one tampered proof that does not), merkle_d12 (the Merkle
     membership example at depth 12, N = 2^13, on the radix-2 plan, at
     most two K5 launches a transform: setup, three proves, the third
     again with GNARK_TPU_MSM_IMPL=scan, the same proof; verify; a wrong
     root does not verify) and rc_20 (2^17 secret 64-bit values
     range-checked through std/rangecheck, one BSB22
     commitment over 589,824 wires, N = 2^20: setup, a prove, verify; a
     swapped commitment and PoK, and a tampered PoK, do not verify);
     then PLONK: mimc_plonk (examples/mimc_plonk.py's circuit, SRS 2048)
     and rc_plonk (16 values through std/rangecheck, one BSB22
     commitment): SRS, setup and a prove on the card (the same prove on
     the CPU, 36-68 s, is left to tests/test_torch_cuda.py:
     cubic_381_plonk below makes that check), verify, a wrong public
     value / a tampered pi2 commitment refused; and
     plonk_20 (2^20 - 1 squaring-chain gates of bench.py's PLONK
     circuit, N = 2^20, the quotient's rho path): an SRS of 2^20 + 8
     (one ladder and one affine_words launch), setup, three proves
     with their launches counted (K10-K14, K1, K2 and the bucket MSM
     must launch, K3 and K5 must not; a steady prove: K14 4, K11 3, K13
     three calls of one kernel, K1 at most 135, K10 at most 54), each
     stage timed by the host
     clock and CUDA events, verify, a tampered claimed value and a
     tampered commitment refused; then for BLS12-381 and BLS12-377:
     g16_381_18 / g16_377_18 (the g16_20 circuit over the curve's scalar
     field: setup, sampled key points against host scalar
     multiplications, three proves with each MSM's digit kernel, K4 and
     K9 once, 14 K2 and 4 K1 launches, no K3; the five MSMs against
     their values from the setup's scalars, H by Schwartz-Zippel,
     verify, a tampered proof refused), plonk_381_18 / plonk_377_18
     (plonk_20's circuit and checks), g16_761_18 (the g16 cell over
     BW6-761's scalar field, last of all; no PLONK cell) and
     cubic_381_plonk /
     cubic_377_plonk (examples/cubic.py's circuit: the card's proof
     equals the CPU's byte for byte, verify, a wrong public value
     refused; cubic_381_plonk and cubic_377_plonk in their curve's
     checks process); BLS12-381's and BLS12-377's
     cells at 2^18 (CELL_LOG: g16_381_18, plonk_381_18, g16_377_18,
     plonk_377_18, every check kept; the time limit's cuts);
  6. every kernel again at the shapes its path gives it, held against
     its plain version on the same inputs (K4 and K9 on the g16_20 setup
     key's columns, 2^20 distinct points, with K4's grouping and passes
     timed apart; the ladder on the g16_20 setup's scalars, bit-exact
     against its plain version on the first 1,024 and against the
     per-bit K7 + K6 sequence on all, both timed; affine_words on the
     ladder's output, bit-exact against the plain chain on the first
     1,024; mont_mul_sub_mul at 2^20 with computeH timed part by part;
     a whole 2^20 K2 transform, coset FFT and iFFT, beside the row_fft +
     K1 + transpose + gather sequence it replaced (on the current row
     kernel); K8 at the widest
     halving step the group fold had and jac_fold at that wire MSM's
     fold, beside the halving tree; one whole 2^13 K5 transform; a 2^25
     domain's ifft(fft(x)) == x, plain and coset; K10-K14 at
     plonk_20's shapes, K14 beside the sequence it replaced and K13's
     dot_many of five columns beside five dot calls); its launches during
     its path, its time, its bound and its plain version's time, as one
     JSON line; the whole bucket MSM at each window width of SWEEP_C on
     those columns and their first 2^16 and 2^13 points (one group
     element at every width); the same for the BLS12-381 builds on
     g16_381_18's key columns and setup (the plain K4 on the first 2^16
     points), its K10-K14 at 2^20 in the sound class, each a row of its
     own ("name@bls12_381") in the JSON line; for BLS12-377 the kernels
     of its own point builds, K4 and K9 in G1 and G2 on g16_377_18's key
     columns, the ladder against the per-bit K7 + K6 and the affine
     kernel on its setup's scalars, and on its scalar field (BN254's
     binaries) a 2^20 K2 transform and K14 (rows "name@bls12_377" for
     the kernels it timed; --quick times its K1, K5, mont_mul_sub_mul
     and K10-K13 too); for BW6-761 (rows "name@bw6_761") K4 and K9 on
     g16_761_18's key columns (the plain K4 on 2^12 points), the ladder
     (16 rows against the host, no per-bit K7 + K6) and the affine kernel
     (the plain chain on 256 points, the K1 chain on all) on its setup,
     and a 2^20 K2 transform, K1 and mont_mul_sub_mul at 12 words; then
     the card's name and power limit, and the device
     as the last line. Each phase's wall time is logged ("[time]").

Option: --quick stops after phase 3, with phase 6's four-step
transform, K8 / jac_fold and K10-K14 timings and a SHARED_FR curve's
K1, K5, mont_mul_sub_mul and K10-K13 (times_shared_fr). --kernel-counts
CURVE only
prints, as JSON, the CUDA kernels one call of each of K10-K14 starts
(phase 3 runs it in a process of its own).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

def mul_ops(nw=8):
    """32-bit multiplies per operation (mul.lo + mul.hi per word pair)
    on nw-word elements: a Montgomery product 4 nw^2 + nw (264 at 8
    words, 588 at 12)."""
    M = 4 * nw * nw + nw            # nw^2 word products, nw^2 to reduce, m
    SOP2 = 6 * nw * nw + nw         # a sum of two products, one reduction
    SOP4 = 10 * nw * nw + nw
    # a squaring at its least cost: G1 each cross product once (nw (nw +
    # 1) / 2 word products); G2 (a0 + a1)(a0 - a1), 2 a0 a1 (two products)
    S = nw * (nw + 1) + 2 * nw * nw + nw
    M2, S2 = 3 * M, 2 * M           # G2: Fp2 product = 3 Fp products
    return {
        "mul": M,
        "proj_add": 8 * M + 3 * SOP2,
        "proj_madd": 7 * M + 3 * SOP2,
        "proj_dbl": 9 * M,
        "proj_add2": 8 * M2 + 3 * 2 * SOP4,   # a G2 sum: a sop4 a lane
        "proj_madd2": 7 * M2 + 3 * 2 * SOP4,
        "proj_dbl2": 9 * M2,
        "sqr": S,
        "jac_madd": 7 * M + 4 * S,            # madd-2007-bl: 7M + 4S
        "jac_dbl": 2 * M + 5 * S,             # dbl-2009-l: 2M + 5S
        "jac_madd2": 7 * M2 + 4 * S2,
        "jac_dbl2": 2 * M2 + 5 * S2,
        "jac_add": 11 * M + 5 * S,            # add-2007-bl: 11M + 5S
        "jac_add2": 11 * M2 + 5 * S2,
        "sop2": SOP2,
        # K14 a row (csrc/plonk_num.cu): 21 products in 13 products, two
        # sop2 and one sop4: 4,864 at 8 words
        "numerator": 13 * M + 2 * SOP2 + SOP4,
    }


MUL_OPS = mul_ops(8)
# the curves beyond BN254 on the card (phases 3, 5, 6), in this order
CURVES2 = ("bls12_381", "bls12_377", "bw6_761")
# curves whose scalar field builds Groth16's kernels alone (12 words:
# K11's inverse takes 8, cuda.sources): no K10-K14, no PLONK cell; a
# card PLONK request is checked to raise before any work
GROTH16_ONLY = ("bw6_761",)
# the time limit's cut 3: these curves' plain twins at small sizes, each
# still past its kernel's block or tile (the plain ladder on 64 scalars,
# the plain affine chain on 256 rows, the plain K4 on 2^12 points in
# phase 6), and no per-bit K7 + K6 beside their setup ladders (16 rows
# against host multiplications instead)
SMALL_PLAIN = ("bw6_761",)
# curves whose scalar field runs BN254's 8-word lazy builds
# (cuda.variant): phase 3 holds those kernels at n <= 2^16 + 3 on the
# curve's constants, phase 6 times a 2^20 K2 transform and K14 of them
SHARED_FR = ("bls12_377",)
# each curve's phase 3 (and cubic cell) runs in a process of its own
# (curve_checks), BN254's too: all started with the builds, each waiting
# for its libraries, then beside BN254's phases 4 and 5 (host-bound:
# circuits, solves); phase 3 measures nothing the run reports but its
# plain ladder's time; each is waited for before its curve's phase 5
# (BN254's before its phase 6)
CHECKS_SEED = 2025
CHECKS_WAIT_S = 900
# the time limit's cuts (the run was over 1,100 s without them): 1. no
# kernels-a-call trace of a SHARED_FR curve's scalar-field kernels
# (BN254's binaries, traced in BN254's phase 3); 2. and 3. plonk and g16
# over BLS12-381 at 2^18 (phase 6's BLS12-381 kernels then on the 2^18
# key's columns and setup), every check kept; with BW6-761's phases, 4.
# BLS12-377's cells at 2^18 too and, as the run with cuts 1-4 took
# 1319 s (one H100, PERF.md §5), 5. BW6-761's g16 cell at 2^18 (its
# phase 6 then on the 2^18 key's columns and setup); with BN254's
# phase 3 in a checks process too, 822 s: cuts 4 and 5 stay, since
# hosts differ by up to 1.35x and 2^20 cells would take a slow one
# past the 1200 s limit
CELL_LOG = {("plonk", "bls12_381"): 18, ("g16", "bls12_381"): 18,
            ("plonk", "bls12_377"): 18, ("g16", "bls12_377"): 18,
            ("g16", "bw6_761"): 18}
HBM_BYTES_PER_S = 3.35e12
DEV = "cuda"          # the card; a rehearsal may set "cpu"
N_CHAINS, CHAIN_LEN = 2048, 512      # 2^20 constraints
SETUP_SEED = 7
MERKLE_DEPTH = 12                    # 7,957 constraints, N = 2^13
RC_VALUES = 1 << 17                  # rc_20: ~720,900 constraints, N = 2^20
PLONK_CHAINS, PLONK_LEN = 2048, 512  # plonk_20: 2^20 - 1 gates, N = 2^20
PLONK_RC_VALUES = 16                 # rc_plonk: 1,392 gates, N = 2^11
C_MAIN = 8            # the bucket MSM's width at 2^20 points; set in main


T_START = time.perf_counter()


def cell_log(kind, cv):
    """log2 of the constraints (gates) of phase 5's cell `kind` (g16,
    plonk) over curve cv."""
    return CELL_LOG.get((kind, cv), 20)


def cell_name(kind, cv):
    """g16_20 and plonk_20 on BN254; g16_381_18, plonk_377_18,
    cubic_381_plonk, ... on the curves beyond."""
    if kind == "cubic":
        return f"cubic_{cv[-3:]}_plonk"
    if cv == "bn254":
        return f"{kind}_20"
    return f"{kind}_{cv[-3:]}_{cell_log(kind, cv)}"


def log(*a):
    """A line of the run's log, after its seconds since the start."""
    print(f"[{time.perf_counter() - T_START:7.1f}]", *a, flush=True)


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

def raw_words(vals, nw=8):
    """Ints below 2^(32 nw) -> (n, nw) int32 words on the device, as they
    are (FF.encode_words reduces mod p, which would undo a lazy value)."""
    import numpy as np
    import torch
    buf = b"".join(v.to_bytes(4 * nw, "little") for v in vals)
    return torch.as_tensor(np.frombuffer(buf, dtype="<i4").copy(),
                           device=DEV).reshape(len(vals), nw)


def rand_words(ff, n, rng, lazy=0):
    """n random canonical Montgomery words; the first `lazy` are pushed
    into [p, 2p), the first of them to 2p - 1 (a product of two such
    operands is the sound class's worst case)."""
    q = ff.p.modulus
    vals = [rng.randrange(q) for _ in range(n)]
    raw = [v * ff.p.R_mod % q for v in vals]
    raw = [v + q if i < lazy else v for i, v in enumerate(raw)]
    if lazy:
        raw[0] = 2 * q - 1
    return raw_words(raw, ff.nw)


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


def group_ff(c, g2):
    """The field of curve c's G1 (Fp) or G2 coordinates: Fp2, or Fp
    itself on BW6-761, whose G2 runs the G1 kernels with its own b3."""
    from gnark_tpu_torch.backend.groth16 import _g2_field
    from gnark_tpu_torch.ff import get_ff
    return _g2_field(c) if g2 else get_ff(c.fp.name)


def is_fp2(ff):
    from gnark_tpu_torch.ec.proj_ec import is_fp2 as fp2
    return fp2(ff)


def max_abs(a, b):
    import torch
    if a.shape != b.shape:
        return float("inf")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def phase_kernels(rng, res, cv="bn254"):
    import torch
    from gnark_tpu_torch import cuda
    from gnark_tpu_torch.backend.groth16 import _to_affine_host
    from gnark_tpu_torch.ec import curves, host
    from gnark_tpu_torch.ec.proj_ec import (proj_add, proj_add_plain,
                                            proj_double, proj_double_plain)
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ff.mont_mul import (mont_mul, mont_mul_plain,
                                             mont_mul_sub_mul,
                                             mont_mul_sub_mul_plain)
    from gnark_tpu_torch.msm.bucket import (bucket_digits, bucket_msm,
                                            bucket_msm_plain,
                                            bucket_reduce,
                                            bucket_reduce_plain, group_b3,
                                            signed_digits)
    from gnark_tpu_torch.msm.pippenger import scalar_limbs
    from gnark_tpu_torch.ntt import Domain, fourstep
    from gnark_tpu_torch.ntt.fourstep import (fourstep_ntt, root_powers,
                                              row_fft, row_fft_plain)

    c = curves.CURVES[cv]
    fr, fp, nbits = get_ff(c.fr.name), get_ff(c.fp.name), c.fr.bits

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
    log(f"K1 mont_mul {cv}: (65536, {fr.nw}|{fp.nw}) x (65536|1) fr+fp "
        f"bit-exact {cuda_ms(lambda: mont_mul(fr, a, b)):.4f} ms")
    # K1's (a*b - c)*d: 2^16 elements, some of each operand in [p, 2p),
    # d per element and broadcast
    err = 0
    for ff in (fr, fp):
        a, b, cc, d = (rand_words(ff, 1 << 16, rng, lazy=1000)
                       for _ in range(4))
        for dd in (d, d[:1]):
            got = mont_mul_sub_mul(ff, a, b, cc, dd)
            want = mont_mul_sub_mul_plain(ff, a, b, cc, dd)
            check(torch.equal(got, want), f"K1 mont_mul_sub_mul {ff.p.name}")
            err = max(err, max_abs(got, want))
    res["mont_mul_sub_mul"]["max_abs_err"] = err
    log(f"K1 mont_mul_sub_mul {cv}: 65536 rows x3 x (65536|1) fr+fp "
        f"bit-exact")

    # K2: its per-row entry on rows of 2^10, 2^9 and 2^12 (the cap, 256
    # threads a block) and 2^13 (a global pass, then two segments); the
    # second curve's build (the same code in the sound class) on 2^10
    # and 2^13 rows, and two of the four-step cases below
    full = cv == "bn254"
    err = 0
    for S in (1 << 10, 1 << 9, 1 << 12, 1 << 13) if full else \
            (1 << 10, 1 << 13):
        x = rand_words(fr, 8 * S, rng, lazy=S).reshape(8, S, fr.nw)
        pw = torch.as_tensor(root_powers(fr, S, fr.p.root_of_unity(S)),
                             device=DEV)
        got, want = row_fft(fr, x, pw), row_fft_plain(fr, x, pw)
        check(torch.equal(got, want), f"K2 row_fft S={S}")
        err = max(err, max_abs(got, want))
        log(f"K2 row_fft {cv}: (8, {S}, {fr.nw}) bit-exact "
            f"{cuda_ms(lambda: row_fft(fr, x, pw)):.4f} ms")
    res["row_fft"]["max_abs_err"] = err
    # the host's copy of the segment block's shared-memory size (which
    # row_plan's fault test reads) against the kernel's own formula
    smem = cuda.lib("row_fft", fr.p.name).gt_fs_smem
    smem.restype = ctypes.c_longlong
    for G in range(1, fourstep.SMEM_LOG + 1):
        host_b = fourstep.seg_smem_bytes(G, fr.nw)
        check(smem(G) == host_b, f"K2 shared memory at 2^{G}, {fr.nw} "
              f"words: kernel {smem(G)}, host {host_b}")
    # whole four-step transforms (two launches each, the scalings inside)
    # against the plain four-step sequence, at 2^12 and 2^13 (the
    # threshold forced down: they take the radix-2 plan by default), and
    # with the shared-memory cap lowered to 2^3 and 2^4 so that every row
    # runs global passes first
    err = 0
    for k, cap in ((12, None), (13, None), (12, 3), (11, 4)) if full else \
            ((12, None), (11, 4)):
        n = 1 << k
        with fourstep_log(k), k2_cap(cap):
            dg = Domain(fr, n, DEV)
            passes = sum(len(rp[0]) for rp in dg._plan(False).rplan)
            before = fourstep_ntt.launches
            err = max(err, transforms_err(dg, Domain(fr, n, "cpu"),
                                          rand_words(fr, n, rng, lazy=n // 3),
                                          "four-step"))
            launched = fourstep_ntt.launches - before
        check(launched == 4 * (2 + passes) and (cap is None) == (passes == 0),
              f"K2 four-step 2^{k} cap {cap}: {launched} launches for 4 "
              f"transforms with {passes} global passes")
        log(f"K2 four-step {cv} 2^{k} (cap {cap or fourstep.SMEM_LOG}): "
            f"fft/ifft/"
            f"coset fft/coset ifft bit-exact, {launched // 4} launches a "
            f"transform ({passes} global passes)")
    res["fourstep_ntt"]["max_abs_err"] = err

    # K3 and K4 in G1 and G2
    err3 = {"proj_add": 0, "proj_double": 0}
    for g2 in (False, True):
        ff = group_ff(c, g2)
        hf = c.host_g2_field if g2 else c.host_fp
        b3 = group_b3(c, g2)
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
        A = point_words(ff, hf, P, rng, g2, lazy)
        B = point_words(ff, hf, Q, rng, g2, 0)
        got, want = proj_add(ff, b3, A, B), proj_add_plain(ff, b3, A, B)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"K3 proj_add {tag}")
        err3["proj_add"] = max([err3["proj_add"]] +
                               [max_abs(u, v) for u, v in zip(got, want)])
        for i in range(8):
            R = _to_affine_host(ff, hf, "proj",
                                tuple(a[i:i + 1] for a in got))
            check(R == host.ec_add(hf, P[i], Q[i]),
                  f"K3 proj_add {tag} vs host at {i}")
        got = proj_double(ff, b3, A)
        want = proj_double_plain(ff, b3, A)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"K3 proj_double {tag}")
        err3["proj_double"] = max([err3["proj_double"]] +
                                  [max_abs(u, v) for u, v in zip(got, want)])
        log(f"K3 proj_add/proj_double {cv} {tag}: ({n}, {A[0].shape[1]}) "
            f"bit-exact, host-checked; add "
            f"{cuda_ms(lambda: proj_add(ff, b3, A, B)):.4f} ms, double "
            f"{cuda_ms(lambda: proj_double(ff, b3, A)):.4f} ms")

        # K4 at c = 8 and at the card's width for the main path: 2^12
        # points with infinity points, zero scalars, duplicates; K9 on its
        # bucket sums
        pts = [base[rng.randrange(64)] for _ in range(n)]
        ks = [rng.randrange(c.fr.modulus) for _ in range(n)]
        inf = torch.zeros(n, dtype=torch.bool, device=DEV)
        inf[5:9] = True
        for i in range(10, 20):
            ks[i] = 0
        for i in range(20, 40):
            ks[i] = 1                               # skew: bucket 0
        x, y = affine_words(ff, pts)
        sc = torch.as_tensor(fr.encode_words(ks, mont=False), device=DEV)
        for cc in sorted({8, C_MAIN}):
            digits = bucket_digits(sc, nbits, cc, c.fp.name)
            got = bucket_msm(ff, b3, x, y, inf, digits, cc)
            want = bucket_msm_plain(ff, b3, x, y, inf, digits, cc)
            err = proj_err(ff, got, want)
            check(err == 0, f"K4 bucket_msm {tag} c={cc}")
            res["bucket_msm"]["max_abs_err"] = max(
                res["bucket_msm"]["max_abs_err"] or 0, err)
            W = digits.shape[0]
            R = bucket_reduce(ff, b3, got, W, cc)
            err = proj_err(ff, R, bucket_reduce_plain(ff, b3, got, W, cc))
            check(err == 0, f"K9 bucket_reduce {tag} c={cc} on K4's sums")
            res["bucket_reduce"]["max_abs_err"] = max(
                res["bucket_reduce"]["max_abs_err"] or 0, err)
            log(f"K4 bucket_msm {cv} {tag} c={cc}: ({n}, {x.shape[1]}) "
                f"points, "
                f"digits {tuple(digits.shape)}, equal as group elements; "
                f"{cuda_ms(lambda: bucket_msm(ff, b3, x, y, inf, digits, cc)):.4f}"
                f" ms; K9 on its {W << (cc - 1)} bucket sums equal as a group "
                f"element")
        k9_edges(ff, hf, b3, gen, base, rng, g2, res, nbits)
    # the digit kernel of K4 against signed_digits at every width
    ks = [rng.randrange(c.fr.modulus) for _ in range(4093)] + \
        [0, 1, c.fr.modulus - 1]
    sc = torch.as_tensor(fr.encode_words(ks, mont=False), device=DEV)
    for cc in range(2, 17):
        got = bucket_digits(sc, nbits, cc, c.fp.name)
        want = signed_digits(scalar_limbs(sc), nbits, cc)
        check(torch.equal(got, want), f"K4 bucket_digits {cv} c={cc}")
    res["bucket_digits"]["max_abs_err"] = 0
    log(f"K4 bucket_digits {cv}: (4096, {fr.nw}) scalars of {nbits} bits "
        f"at c = 2..16 bit-exact")
    for k, v in err3.items():
        res[k]["max_abs_err"] = v


def k9_edges(ff, hf, b3, gen, base, rng, g2, res, nbits):
    """K9 against its plain version as group elements: all buckets empty,
    one non-empty bucket per window (and the host's value), and at c = 8
    every bucket full with lazy X coordinates in [p, 2p) and equal
    neighbours (the doubling case of the running sums)."""
    import torch
    from gnark_tpu_torch.backend.groth16 import _to_affine_host
    from gnark_tpu_torch.ec import host
    from gnark_tpu_torch.msm.bucket import (bucket_reduce,
                                            bucket_reduce_plain,
                                            digit_count)
    tag = "G2" if g2 else "G1"
    # the second curve's: c = 8 (C_MAIN is held on K4's sums already;
    # the wider plain epilogues took ~30 s of the time limit)
    widths = sorted({8, C_MAIN, 16} if ff.p.name.startswith("bn254") else
                    {8})
    for cc in widths:
        W, B = digit_count(nbits, cc), 1 << (cc - 1)
        P = point_words(ff, hf, [host.INF], rng, g2, 0)
        P = tuple(a.expand(W * B, -1).contiguous() for a in P)
        R = bucket_reduce(ff, b3, P, W, cc)
        check(_to_affine_host(ff, hf, "proj", R) == host.INF,
              f"K9 {tag} c={cc}: empty buckets do not give the identity")
        pts = [base[rng.randrange(64)] for _ in range(W)]
        js = [rng.randrange(B) for _ in range(W)]
        Q = point_words(ff, hf, pts, rng, g2, W // 2)
        rows = torch.as_tensor([w * B + j for w, j in enumerate(js)],
                               device=DEV)
        for a, q in zip(P, Q):
            a[rows] = q
        R = bucket_reduce(ff, b3, P, W, cc)
        err = proj_err(ff, R, bucket_reduce_plain(ff, b3, P, W, cc))
        want = host.ec_msm(hf, pts, [(j + 1) << (cc * w)
                                     for w, j in enumerate(js)])
        check(err == 0 and _to_affine_host(ff, hf, "proj", R) == want,
              f"K9 {tag} c={cc}: one bucket a window")
        res["bucket_reduce"]["max_abs_err"] = max(
            res["bucket_reduce"]["max_abs_err"] or 0, err)
    W, B = 32, 128
    pts = [base[rng.randrange(64)] for _ in range(W * B)]
    for i in range(0, W * B, 2):
        pts[i + 1] = pts[i]                       # equal neighbours
    for i in range(0, W * B, 97):
        pts[i] = host.INF
    P = point_words(ff, hf, pts, rng, g2, W * B // 2)
    R = bucket_reduce(ff, b3, P, W, 8)
    err = proj_err(ff, R, bucket_reduce_plain(ff, b3, P, W, 8))
    check(err == 0, f"K9 {tag} c=8: full buckets, lazy inputs")
    log(f"K9 bucket_reduce {ff.p.name} {tag}: empty buckets, one bucket a "
        f"window (c = {widths}, host-checked), {W * B} full buckets "
        f"with equal neighbours and X in [p, 2p): equal as group elements; "
        f"{cuda_ms(lambda: bucket_reduce(ff, b3, P, W, 8)):.4f} ms at c = 8")


@contextlib.contextmanager
def setenv(name, value):
    """Environment variable `name` is `value` inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def fourstep_log(k):
    """Domains of 2^k and up take the four-step plan inside the block."""
    return setenv("GNARK_TPU_NTT_FOURSTEP_LOG", str(k))


@contextlib.contextmanager
def k2_cap(cap=None):
    """Inside the block, four-step plans made there hold row segments of
    at most 2^cap points in shared memory (None: the module's value)."""
    from gnark_tpu_torch.ntt import fourstep
    old = fourstep.SMEM_LOG
    fourstep.SMEM_LOG = cap or old
    try:
        yield
    finally:
        fourstep.SMEM_LOG = old


def scan_msm():
    """Every MSM takes the scan path (K6, K8, K7) inside the block."""
    return setenv("GNARK_TPU_MSM_IMPL", "scan")


def all_wrappers():
    from gnark_tpu_torch.ec.jac_ec import (jac_add, jac_add_mixed, jac_double,
                                           jac_fold)
    from gnark_tpu_torch.backend.plonk_num import plonk_numerator
    from gnark_tpu_torch.ec.proj_ec import proj_add, proj_double
    from gnark_tpu_torch.ff import ops
    from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_sub_mul
    from gnark_tpu_torch.msm.bucket import (bucket_digits, bucket_msm,
                                            bucket_reduce)
    from gnark_tpu_torch.msm.fixed_base import affine_words, batch_scalar_mul
    from gnark_tpu_torch.ntt.fourstep import fourstep_ntt, row_fft
    from gnark_tpu_torch.ntt.radix2 import butterfly, radix2_ntt
    return (mont_mul, row_fft, proj_add, proj_double, bucket_msm, radix2_ntt,
            jac_add_mixed, jac_double, jac_add, bucket_reduce, bucket_digits,
            batch_scalar_mul, mont_mul_sub_mul, affine_words, butterfly,
            fourstep_ntt, jac_fold, ops.ff_addsub, ops.batch_inv,
            ops.scan_mul, ops.dot, ops.dot_many, plonk_numerator)


def scan_prove(what, fn):
    """fn() under GNARK_TPU_MSM_IMPL=scan with every launch count set to
    0 first; K6, K7, K8 and its group fold must launch and K4 must not.
    Returns (fn's result, the launch counts)."""
    wrappers = all_wrappers()
    for wr in wrappers:
        wr.launches = 0
    with scan_msm():
        out = fn()
    launches = {wr.__name__: wr.launches for wr in wrappers}
    log(f"launches during the {what} scan-path prove: {json.dumps(launches)}")
    for k in ("jac_add", "jac_add_mixed", "jac_double", "jac_fold"):
        check(launches[k] > 0, f"{what} scan path: {k} was not launched")
    for k in ("bucket_msm", "bucket_reduce", "bucket_digits"):
        check(launches[k] == 0, f"{what} scan path launched {k}")
    return out, launches


def transforms_err(dg, dc, x, what):
    """fft / ifft / coset fft / coset ifft of x on the card's Domain dg
    against the CPU Domain dc (plain versions); fails unless bit-exact."""
    import torch
    err = 0
    for name, coset, inv in (("fft", False, False), ("ifft", False, True),
                             ("coset fft", True, False),
                             ("coset ifft", True, True)):
        fg, fc = (dg.ifft, dc.ifft) if inv else (dg.fft, dc.fft)
        got, want = fg(x, coset=coset).cpu(), fc(x.cpu(), coset=coset)
        check(torch.equal(got, want), f"{what} {dg.n} {name}")
        err = max(err, max_abs(got, want))
    return err


def phase_kernels_jac_ntt(rng, res, cv="bn254"):
    """K5: whole transforms at every n from 2^1 to 2^13, forward and
    inverse, on inputs in [p, 2p), its one-stage helper over every stage
    of 2^13, and the Domain's 2^13 transforms; K6, K7 and K8 over 2^12
    points in G1 and G2 with edge cases."""
    import numpy as np
    import torch
    from gnark_tpu_torch.ec import curves, host
    from gnark_tpu_torch.ec.jac_ec import (jac_add, jac_add_mixed,
                                           jac_add_mixed_plain, jac_add_plain,
                                           jac_double, jac_double_plain)
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ntt import Domain
    from gnark_tpu_torch.ntt.radix2 import (butterfly, butterfly_plain,
                                            ntt_launches, radix2_ntt,
                                            radix2_ntt_plain, stage_twiddles)

    c = curves.CURVES[cv]
    fr = get_ff(c.fr.name)
    q = fr.p.modulus
    err = 0
    for k in range(1, 14):
        m = 1 << k
        for w in (fr.p.root_of_unity(m), pow(fr.p.root_of_unity(m), -1, q)):
            tw = torch.as_tensor(np.concatenate(stage_twiddles(fr, m, w)),
                                 device=DEV)
            x = rand_words(fr, m, rng, lazy=m // 3 + 1)
            before = radix2_ntt.launches
            got = radix2_ntt(fr, x, tw)
            check(radix2_ntt.launches - before == ntt_launches(m) <= 2,
                  f"K5 radix2_ntt 2^{k}: {radix2_ntt.launches - before} "
                  f"launches")
            want = radix2_ntt_plain(fr, x, tw)
            check(torch.equal(got, want), f"K5 radix2_ntt 2^{k}")
            err = max(err, max_abs(got, want))
    res["radix2_ntt"]["max_abs_err"] = err
    log(f"K5 radix2_ntt {cv}: every n from 2^1 to 2^13, forward and "
        "inverse, a third of the inputs in [p, 2p), bit-exact; one launch "
        "up to 2^10, two above")
    n = 1 << 13
    tws = stage_twiddles(fr, n, fr.p.root_of_unity(n))
    err = 0
    for tw in tws:
        tw = torch.as_tensor(tw, device=DEV)
        y = rand_words(fr, n, rng, lazy=500)
        got = butterfly(fr, y.clone(), tw)
        want = butterfly_plain(fr, y.clone(), tw)
        check(torch.equal(got, want), f"K5 butterfly half={tw.shape[0]}")
        err = max(err, max_abs(got, want))
    err = max(err, transforms_err(Domain(fr, n, DEV), Domain(fr, n, "cpu"),
                                  rand_words(fr, n, rng), "radix-2"))
    res["radix2_ntt"]["max_abs_err"] = max(res["radix2_ntt"]["max_abs_err"],
                                           err)
    log(f"K5's one-stage helper butterfly: all 13 stages of 2^13 (500 "
        f"inputs in [p, 2p)) bit-exact; 2^13 fft/ifft/coset fft/coset ifft "
        f"bit-exact")

    errs = {"jac_add_mixed": 0, "jac_double": 0, "jac_add": 0,
            "jac_fold": 0}
    for g2 in (False, True):
        ff = group_ff(c, g2)
        hf = c.host_g2_field if g2 else c.host_fp
        gen = c.g2 if g2 else c.g1
        tag = "G2" if g2 else "G1"
        base = [gen]
        for _ in range(63):
            base.append(host.ec_add(hf, base[-1], gen))
        m = 1 << 12
        P = [base[rng.randrange(64)] for _ in range(m)]
        A = [base[rng.randrange(64)] for _ in range(m)]
        inf2 = [rng.random() < 0.1 for _ in range(m)]
        P[0], inf2[0] = host.INF, False           # infinity accumulator
        inf2[1] = True                            # masked operand
        A[2], inf2[2] = P[2], False               # R == A: doubling
        A[3], inf2[3] = host.ec_neg(hf, P[3]), False   # R == -A
        P[4], inf2[4] = host.INF, True
        Pw = point_words(ff, hf, P, rng, g2, 200, jacobian=True)
        x2, y2 = affine_words(ff, A)              # ignored where masked
        mask = torch.tensor(inf2, device=DEV)
        for name, fn, pfn, want_host, args in (
                ("jac_add_mixed", jac_add_mixed, jac_add_mixed_plain,
                 lambda i: P[i] if inf2[i] else host.ec_add(hf, P[i], A[i]),
                 (x2, y2, mask)),
                ("jac_add_mixed", jac_add_mixed, jac_add_mixed_plain,
                 lambda i: P[i] if inf2[i] else host.ec_add(hf, P[i], gen),
                 affine_words(ff, [gen]) + (mask,)),       # broadcast
                ("jac_double", jac_double, jac_double_plain,
                 lambda i: host.ec_dbl(hf, P[i]), ())):
            got, want = fn(ff, Pw, *args), pfn(ff, Pw, *args)
            check(all(torch.equal(u, v) for u, v in zip(got, want)),
                  f"K6/K7 {name} {tag}")
            errs[name] = max([errs[name]] +
                             [max_abs(u, v) for u, v in zip(got, want)])
            for i in range(8):
                check(jac_to_host(ff, hf, got, i) == want_host(i),
                      f"{name} {tag} vs host at {i}")
        log(f"K6 jac_add_mixed (per-row and broadcast operand) / K7 "
            f"jac_double {cv} {tag}{' on lane pairs' if g2 else ''}: "
            f"({m}, {Pw[0].shape[1]}) bit-exact, host-checked")

        # K8: P + Q with P == Q (another Z), P == -Q, either or both at
        # infinity, coordinates of both in [p, 2p), and random pairs
        P = [base[rng.randrange(64)] for _ in range(m)]
        Q = [base[rng.randrange(64)] for _ in range(m)]
        Q[0] = host.INF                           # P + infinity
        P[1] = host.INF                           # infinity + Q
        P[2] = Q[2] = host.INF
        Q[3] = P[3]                               # doubling
        Q[4] = host.ec_neg(hf, P[4])              # P + (-P)
        Pw = point_words(ff, hf, P, rng, g2, 200, jacobian=True)
        Qw = point_words(ff, hf, Q, rng, g2, 100, jacobian=True)
        got, want = jac_add(ff, Pw, Qw), jac_add_plain(ff, Pw, Qw)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"K8 jac_add {tag}")
        errs["jac_add"] = max([errs["jac_add"]] +
                              [max_abs(u, v) for u, v in zip(got, want)])
        for i in range(8):
            check(jac_to_host(ff, hf, got, i) == host.ec_add(hf, P[i], Q[i]),
                  f"jac_add {tag} vs host at {i}")
        log(f"K8 jac_add {cv} {tag}{' on lane pairs' if g2 else ''}: "
            f"({m}, {Pw[0].shape[1]}) bit-exact, host-checked; "
            f"{cuda_ms(lambda: jac_add(ff, Pw, Qw)):.4f} ms")
        errs["jac_fold"] = max(errs["jac_fold"],
                               fold_check(ff, hf, base, rng, g2))
    for k, v in errs.items():
        res[k]["max_abs_err"] = v


def fold_check(ff, hf, base, rng, g2, W=3, G=16, B=131):
    """jac_fold on curve points against its plain twin (bit-exact), the
    halving tree of K8 it replaced (the same points) and the host's sums
    (sampled columns): a column of equal points (the doubling branch), one
    of P and -P, one all at infinity, X in [p, 2p)."""
    import torch
    from gnark_tpu_torch.backend.groth16 import _to_affine_host
    from gnark_tpu_torch.ec import host
    from gnark_tpu_torch.ec.jac_ec import jac_add, jac_fold, jac_fold_plain
    pts = [base[rng.randrange(64)] for _ in range(W * G * B)]

    def row(w, g, b):
        return (w * G + g) * B + b

    for g in range(G):
        pts[row(0, g, 1)] = base[3]
        pts[row(2, g, 5)] = host.INF
    pts[row(1, 0, 2)], pts[row(1, 1, 2)] = base[9], host.ec_neg(hf, base[9])
    P = point_words(ff, hf, pts, rng, g2, 300, jacobian=True)
    got, want = jac_fold(ff, P, G, B), jac_fold_plain(ff, P, G, B)
    check(all(torch.equal(u, v) for u, v in zip(got, want)),
          f"jac_fold {'G2' if g2 else 'G1'}")
    err = max(max_abs(u, v) for u, v in zip(got, want))
    Lw = P[0].shape[1]
    T = torch.stack(P).reshape(3, W, G, B, Lw)
    g = G
    while g > 1:
        h = g // 2
        R = jac_add(ff, tuple(a.reshape(-1, Lw) for a in T[:, :, :h]),
                    tuple(a.reshape(-1, Lw) for a in T[:, :, h:g]))
        T = torch.stack(R).reshape(3, W, h, B, Lw)
        g = h
    for w, b in [(0, 1), (1, 2), (2, 5), (2, B - 1)] + \
            [(rng.randrange(W), rng.randrange(B)) for _ in range(12)]:
        want = host.INF
        for gg in range(G):
            want = host.ec_add(hf, want, pts[row(w, gg, b)])
        i = w * B + b
        check(jac_to_host(ff, hf, got, i) == want == _to_affine_host(
            ff, hf, "jac", tuple(a[w, 0, b][None] for a in T)),
            f"jac_fold {'G2' if g2 else 'G1'} column ({w}, {b})")
    log(f"jac_fold {'G2 on lane pairs' if g2 else 'G1'}: W = {W}, G = {G}, "
        f"B = {B} bit-exact against its plain twin; 16 columns equal to the "
        f"halving tree of K8 and the host's sums (equal points, P and -P, "
        f"all at infinity)")
    return err


LADDER_ROWS = 1024


def phase_kernels_ladder(rng, res, cv="bn254"):
    """The fused ladder against its plain version (the per-bit plain K7
    + K6) at the scalar field's bits (254 on BN254, 255 on BLS12-381) on
    1,029 scalars (64 on a SMALL_PLAIN curve) in G1 and G2, bit-exact:
    0, 1,
    r - 1, r (the last add is P + (-P)) and r + 2 (P + P, the doubling
    branch), written as they are, then random ones; the edge rows
    against the host."""
    import torch
    from gnark_tpu_torch.ec import curves, host
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ec.proj_ec import _lw
    from gnark_tpu_torch.msm.fixed_base import (batch_scalar_mul,
                                                batch_scalar_mul_plain)
    c = curves.CURVES[cv]
    r, nbits = c.fr.modulus, c.fr.bits
    rows = 59 if cv in SMALL_PLAIN else LADDER_ROWS
    ks = [0, 1, r - 1, r, r + 2] + [rng.randrange(r) for _ in range(rows)]
    sc = raw_words(ks, get_ff(c.fr.name).nw)
    err = 0
    for g2 in (False, True):
        ff = group_ff(c, g2)
        hf = c.host_g2_field if g2 else c.host_fp
        gen = c.g2 if g2 else c.g1
        base = affine_words(ff, [gen])
        got = batch_scalar_mul(ff, base, nbits, sc)
        pms, want = timed(lambda: batch_scalar_mul_plain(ff, base, nbits,
                                                         sc), 1, warm=False)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"ladder {'G2' if g2 else 'G1'}")
        err = max([err] + [max_abs(u, v) for u, v in zip(got, want)])
        res["batch_scalar_mul"]["phase3_plain" + ("_g2" if g2 else "")] = \
            (pms, [len(ks), _lw(ff), nbits])
        for i, k in enumerate(ks[:5]):
            check(jac_to_host(ff, hf, got, i) == host.ec_mul(hf, gen, k % r),
                  f"ladder {'G2' if g2 else 'G1'} vs host at scalar {i}")
        log(f"ladder {cv} {'G2 on lane pairs' if g2 else 'G1'}: {len(ks)} "
            f"scalars at {nbits} bits (0, 1, r - 1, r, r + 2, random) "
            f"bit-exact against the per-bit plain K7 + K6 "
            f"({pms:.1f} ms), host-checked")
    res["batch_scalar_mul"]["max_abs_err"] = err


def lazy_rows(words, q, nw=8):
    """Each nw-word element of the rows plus p: canonical -> [p, 2p)."""
    import numpy as np
    arr = np.ascontiguousarray(words.cpu().numpy().astype("<i4"))
    vals = [int.from_bytes(r.tobytes(), "little") + q
            for r in arr.reshape(-1, nw)]
    return raw_words(vals, nw).reshape(words.shape)


AFFINE_TILE = 1024


def phase_kernels_affine(rng, res, cv="bn254"):
    """K1's affine kernel (affine_words) against its plain version, the
    Fermat chain of plain products, on 1,024 G1 and G2 Jacobian points
    (256 on a SMALL_PLAIN curve) from the host: infinity (Z = 0), Z = 1,
    Z in [p, 2p) (and X in [p, 2p)), random Z; bit-exact, and the edge
    rows equal the host's affine points."""
    import torch
    from gnark_tpu_torch.backend.groth16 import _host_points
    from gnark_tpu_torch.ec import curves, host
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.msm import fixed_base
    c = curves.CURVES[cv]
    q = c.fp.modulus
    nw = get_ff(c.fp.name).nw
    err = 0
    for g2 in (False, True):
        ff = group_ff(c, g2)
        hf = c.host_g2_field if g2 else c.host_fp
        gen = c.g2 if g2 else c.g1
        tag = "G2" if g2 else "G1"
        base = [gen]
        for _ in range(63):
            base.append(host.ec_add(hf, base[-1], gen))
        m = 256 if cv in SMALL_PLAIN else 1024
        pts = [base[rng.randrange(64)] for _ in range(m)]
        pts[0] = pts[7] = host.INF
        X, Y, Z = point_words(ff, hf, pts, rng, g2, 100, jacobian=True)
        x1, y1 = affine_words(ff, pts[1:2])                 # Z = 1
        X[1], Y[1] = x1[0], y1[0]
        Z[1] = torch.as_tensor(ff.encode_words([(1, 0) if is_fp2(ff)
                                                else 1]),
                               device=DEV).reshape(-1)
        Z[2:200] = lazy_rows(Z[2:200], q, nw)               # Z in [p, 2p)
        P = (X, Y, Z)
        got = fixed_base.affine_words(ff, P)
        want = fixed_base.affine_words_plain(ff, P)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"K1 affine_words {tag}")
        err = max([err] + [max_abs(u, v) for u, v in zip(got, want)])
        idx = [0, 1, 2, 3, 7, 200, 201]
        shp = (-1, 2, nw) if is_fp2(ff) else (-1, nw)
        inf = torch.tensor([pts[i] is host.INF for i in idx])
        check(_host_points(ff, *(a[idx].reshape(shp) for a in got), inf) ==
              [pts[i] for i in idx], f"K1 affine_words {tag} vs host")
        check(all(int(a[i].abs().sum()) == 0 for a in got for i in (0, 7)),
              f"K1 affine_words {tag}: infinity is not (0, 0)")
        # the same points tiled 1024 times: more points than the kernel's
        # threads, so each thread's batch inversion spans many of them,
        # infinity and lazy Z included
        big = fixed_base.affine_words(ff, tuple(a.repeat(AFFINE_TILE, 1)
                                                for a in P))
        check(all(torch.equal(u, v.repeat(AFFINE_TILE, 1))
                  for u, v in zip(big, got)),
              f"K1 affine_words {tag}: the tiled batch differs")
        log(f"K1 affine_words {cv} {tag}: ({m}, {X.shape[1]}) Jacobian points "
            f"(infinity, Z = 1, Z in [p, 2p), random Z) bit-exact against "
            f"the plain Fermat chain, host-checked; the same words tiled "
            f"to {m * AFFINE_TILE} points")
    res["affine_words"]["max_abs_err"] = err


def jac_to_host(ff, hf, P, i):
    """Row i of Jacobian words -> host affine point."""
    from gnark_tpu_torch.backend.groth16 import _to_affine_host
    return _to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in P))


def point_words(ff, hf, pts, rng, g2, lazy, jacobian=False):
    """Host affine points -> words (X, Y, Z) on the card with a random Z:
    projective (x z, y z, z), identity (0, 1, 0), or Jacobian (x z^2,
    y z^3, z), infinity (1, 1, 0); the first `lazy` X coordinates are
    pushed into [p, 2p)."""
    import torch
    from gnark_tpu_torch.ec import host
    g2 = is_fp2(ff)            # the coordinates' layout (G2 over Fp: one)
    q = ff.p.modulus
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    X, Y, Z = [], [], []
    for P in pts:
        if P is host.INF:
            X.append(one if jacobian else zero)
            Y.append(one)
            Z.append(zero)
            continue
        z = (rng.randrange(1, q), rng.randrange(q)) if g2 else \
            rng.randrange(1, q)
        zx, zy = (hf.mul(z, z), hf.mul(hf.mul(z, z), z)) if jacobian else \
            (z, z)
        X.append(hf.mul(P[0], zx))
        Y.append(hf.mul(P[1], zy))
        Z.append(z)
    n = len(pts)
    base = ff.base if g2 else ff
    out = []
    for vals in (X, Y, Z):
        flat = [v for t in vals for v in t] if g2 else vals
        mont = [v * base.p.R_mod % q for v in flat]
        if vals is X:
            k = 2 if g2 else 1
            mont = [v + q if i < lazy * k else v for i, v in enumerate(mont)]
        out.append(raw_words(mont, base.nw).reshape(n, -1))
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
    from gnark_tpu_torch.backend.groth16_check import (CheckError,
                                                       check_prove,
                                                       known_log_key,
                                                       synth_square_chain)
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ntt import get_domain

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

    proofs = three_proves(res, cs, pk, "g16_20")
    t = time.perf_counter()
    try:
        check_prove(cs, pk, [], [j + 2 for j in range(N_CHAINS)],
                    random.Random(7))
    except CheckError as e:
        raise Fail(str(e))
    log("main path: the five MSMs equal their known-log values and "
        "A(tau)B(tau) - C(tau) == H(tau)(tau^N - 1) "
        f"(checked in {time.perf_counter() - t:.1f} s)")
    return pk.g1_a[0].shape[0], cs, pk, proofs[0]


def three_proves(res, cs, pk, what, chains=N_CHAINS):
    """Three Groth16 proves of the squaring chain with every launch count
    set to 0 first: each MSM runs the digit kernel, K4 and K9 once and
    K3 not at all, each computeH one mont_mul_sub_mul, 14 K2 launches
    (seven transforms, the scalings and the mid twiddle inside) and 4 K1
    (three to Montgomery form, one out of it), no row_fft. Returns the
    proofs."""
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.ec.proj_ec import proj_add, proj_double
    from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_sub_mul
    from gnark_tpu_torch.msm.bucket import (bucket_digits, bucket_msm,
                                            bucket_reduce)
    from gnark_tpu_torch.ntt.fourstep import fourstep_ntt, row_fft
    wrappers = (mont_mul, mont_mul_sub_mul, fourstep_ntt, row_fft, proj_add,
                proj_double, bucket_digits, bucket_msm, bucket_reduce)
    for wr in wrappers:
        wr.launches = 0
    proofs = []
    for i in range(3):
        sec = [(i * 7919 + j + 2) for j in range(chains)]
        tm = {}
        t = time.perf_counter()
        proof = groth16.prove(cs, pk, [], sec, rng=random.Random(100 + i),
                              timings=tm)
        tm["total"] = time.perf_counter() - t
        check(None not in (proof.ar, proof.krs, proof.bs),
              f"{what}: prove returned an identity point")
        proofs.append(proof)
        log(f"{what} prove {i} (s): {fmt_times(tm)}")
    launches = {wr.__name__: wr.launches for wr in wrappers}
    log(f"launches during 3 {what} proves: " + json.dumps(launches))
    for k, v in launches.items():
        res[k]["launches"] = v
        if k in ("proj_add", "proj_double"):
            check(v == 0, f"{what}: K3 {k} was launched {v} times on the "
                  f"main path (the epilogue is K9's)")
        elif k == "row_fft":
            check(v == 0, f"{what}: row_fft was launched {v} times on the "
                  f"main path (its transforms are fourstep_ntt's)")
        else:
            check(v > 0, f"{what}: kernel {k} was not launched on the main "
                  f"path")
    for k in ("bucket_digits", "bucket_msm", "bucket_reduce"):
        check(launches[k] == 3 * 5, f"{what}: {k} launched {launches[k]} "
              f"times in 3 proves, not once for each of the 5 MSMs")
    check(launches["mont_mul_sub_mul"] == 3, f"{what}: mont_mul_sub_mul "
          f"launched {launches['mont_mul_sub_mul']} times in 3 proves, not "
          f"once each")
    check(launches["fourstep_ntt"] == 3 * 14 and launches["mont_mul"] == 3 * 4,
          f"{what}: 3 proves launched K2 {launches['fourstep_ntt']} times "
          f"(not 42) and K1 {launches['mont_mul']} times (not 12)")
    return proofs


# ---------------------------------------------------------------------------
# phase 5: setup -> prove -> verify
# ---------------------------------------------------------------------------

def fmt_times(tm):
    return json.dumps({k: round(v, 4) for k, v in tm.items()})


def timed_setup(cs, what, cv="bn254"):
    """groth16.setup over curve cv on the card, timed by phase; the
    ladder kernel and K1's affine kernel must launch once for each of
    the two groups, and K6, K7 and K1's product not at all."""
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.ec.jac_ec import jac_add_mixed, jac_double
    from gnark_tpu_torch.ff.mont_mul import mont_mul
    from gnark_tpu_torch.msm.fixed_base import affine_words, batch_scalar_mul
    wrappers = (batch_scalar_mul, affine_words, jac_add_mixed, jac_double,
                mont_mul)
    for wr in wrappers:
        wr.launches = 0
    tm = {}
    t = time.perf_counter()
    pk, vk = groth16.setup(cs, cv, rng=random.Random(SETUP_SEED),
                           timings=tm)
    tm["total"] = time.perf_counter() - t
    launches = {wr.__name__: wr.launches for wr in wrappers}
    log(f"{what} setup (s): {fmt_times(tm)}; launches {json.dumps(launches)}")
    for k in ("batch_scalar_mul", "affine_words"):
        check(launches[k] == 2, f"{what} setup launched {k} {launches[k]} "
              f"times, not once a group")
    for k in ("jac_add_mixed", "jac_double", "mont_mul"):
        check(launches[k] == 0,
              f"{what} setup launched {k} {launches[k]} times, not 0")
    return pk, vk, launches


def check_key(cs, pk, vk, rng, k=64):
    """k sampled points of every key column, and every vk and host
    point, against host.ec_mul(generator, scalar) for the scalars
    recomputed from the setup's seed."""
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.ec import host
    from gnark_tpu_torch.ff import get_ff
    curve = pk.curve
    s = groth16.setup_scalars(cs, curve, random.Random(SETUP_SEED))
    f1, f2 = curve.host_fp, curve.host_g2_field
    nw, npub, N = cs.nb_wires, cs.nb_public, s["N"]
    o_z = 3 + 2 * nw
    o_vk = o_z + N
    cols = (("g1_a", 3, False), ("g1_b", 3 + nw, False), ("g1_z", o_z, False),
            ("g1_k", o_vk + npub, False), ("g2_b", 3, True))
    ffp = get_ff(curve.fp.name)
    ff2 = groth16._g2_field(curve)
    for name, off, g2 in cols:
        P = getattr(pk, name)
        n = P[0].shape[0]
        idx = sorted({0, n - 1} | {rng.randrange(n) for _ in range(k - 2)})
        got = groth16._host_points(ff2 if g2 else ffp,
                                   *(a[idx] for a in P))
        sc = s["g2" if g2 else "g1"]
        for i, pt in zip(idx, got):
            want = host.ec_mul(f2 if g2 else f1, curve.g2 if g2 else curve.g1,
                               sc[off + i])
            check(pt == want, f"key column {name}[{i}] != [s] G")
    want = {"g1_alpha": (f1, curve.g1, s["alpha"]),
            "g1_beta": (f1, curve.g1, s["beta"]),
            "g1_delta": (f1, curve.g1, s["delta"]),
            "g2_beta": (f2, curve.g2, s["beta"]),
            "g2_delta": (f2, curve.g2, s["delta"])}
    for name, (f, g, x) in want.items():
        check(getattr(pk, name) == host.ec_mul(f, g, x), f"pk.{name}")
    check(vk.g2_gamma == host.ec_mul(f2, curve.g2, s["gamma"]), "vk.g2_gamma")
    for i, pt in enumerate(vk.g1_k):
        check(pt == host.ec_mul(f1, curve.g1, s["g1"][o_vk + i]),
              f"vk.g1_k[{i}]")
    return s


def phase_setup(res, cs, rng):
    """g16_20: Setup at 2^20, its key against host scalar
    multiplications, one proof that verifies and one tampered that does
    not. Returns the setup's G1 and G2 scalars as words on the card (for
    phase 6's ladder) and the key's A and B columns."""
    from gnark_tpu_torch.backend import groth16
    import torch
    from gnark_tpu_torch.ff import get_ff
    pk, vk, launches = timed_setup(cs, "g16_20")
    for k in ("batch_scalar_mul", "affine_words"):
        res[k]["launches"] = launches[k]
    t = time.perf_counter()
    s = check_key(cs, pk, vk, rng)
    log(f"g16_20 key: 64 sampled points of each of the five columns, the "
        f"five host points and the vk equal [s] G for the recomputed "
        f"scalars (checked in {time.perf_counter() - t:.1f} s)")
    sec = [j + 2 for j in range(N_CHAINS)]
    tm = {}
    t = time.perf_counter()
    proof = groth16.prove(cs, pk, [], sec, rng=random.Random(11), timings=tm)
    tm["total"] = time.perf_counter() - t
    log(f"g16_20 prove on the setup key (s): {fmt_times(tm)}")
    t = time.perf_counter()
    check(groth16.verify(proof, vk, []), "g16_20: verify rejected a proof")
    log(f"g16_20 verify: True in {time.perf_counter() - t:.3f} s")
    other = groth16.prove(cs, pk, [], sec, rng=random.Random(12))
    bad = groth16.Proof(ar=proof.ar, krs=other.krs, bs=proof.bs)
    check(not groth16.verify(bad, vk, []),
          "g16_20: verify accepted Ar and Krs of two proofs")
    log("g16_20 verify of Ar from one proof and Krs from another: False")
    fr = get_ff(pk.curve.fr.name)
    ladder_sc = tuple(torch.as_tensor(fr.encode_words(s[g], mont=False),
                                      device=DEV) for g in ("g1", "g2"))
    return ladder_sc, (pk.g1_a, pk.g2_b)


def phase_g16_2(res, rng, cv):
    """g16_381_18 / g16_377_18: bench.py's g16_20 squaring chain (2^20
    constraints; 2^cell_log) over curve cv's scalar field: setup on the
    card (one ladder
    and one affine_words launch a group), 64 sampled points of each key
    column against host scalar multiplications, three proves (each MSM
    the digit kernel, K4 and K9 once, K3 none; 14 K2 and 4 K1 launches
    and one mont_mul_sub_mul a prove), the first's five MSMs against
    their values from the setup's scalars and H by Schwartz-Zippel,
    verify, and a proof with Ar and Krs of two proves refused. Returns
    the setup's G1 and G2 scalars as words (phase 6's ladder) and the
    key's A and B columns (phase 6's K4 and K9)."""
    import torch
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.backend.groth16_check import (
        CheckError, check_prove, setup_logs, synth_square_chain)
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ntt import get_domain
    what, lg = cell_name("g16", cv), cell_log("g16", cv)
    chains = N_CHAINS >> (20 - lg)
    curve = curves.CURVES[cv]
    t = time.perf_counter()
    cs = synth_square_chain(chains, CHAIN_LEN, curve.fr)
    log(f"{what}: circuit {cs.summary()} built in "
        f"{time.perf_counter() - t:.2f} s")
    pk, vk, launches = timed_setup(cs, what, cv)
    check(pk.domain_n == 1 << lg, f"{what}: N = {pk.domain_n}, not 2^{lg}")
    for k in ("batch_scalar_mul", "affine_words"):
        res[k]["launches"] = launches[k]
    t = time.perf_counter()
    s = check_key(cs, pk, vk, rng, k=24)   # 12-word host products
    log(f"{what} key: 24 sampled points of each of the five columns, the "
        f"five host points and the vk equal [s] G for the recomputed "
        f"scalars (checked in {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    get_domain(get_ff(curve.fr.name), pk.domain_n, DEV)  # its K1 tables
    sync()
    log(f"{what}: domain tables in {time.perf_counter() - t:.2f} s")
    proofs = three_proves(res, cs, pk, what, chains)
    t = time.perf_counter()
    try:
        check_prove(cs, pk, [], [j + 2 for j in range(chains)],
                    random.Random(7), logs=setup_logs(cs, s))
    except CheckError as e:
        raise Fail(f"{what}: {e}")
    log(f"{what}: the five MSMs equal their values from the setup's "
        f"scalars and A(tau)B(tau) - C(tau) == H(tau)(tau^N - 1) (checked "
        f"in {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    check(groth16.verify(proofs[0], vk, []), f"{what}: verify rejected a "
          f"proof")
    log(f"{what} verify: True in {time.perf_counter() - t:.3f} s")
    bad = groth16.Proof(ar=proofs[0].ar, krs=proofs[1].krs, bs=proofs[0].bs)
    check(not groth16.verify(bad, vk, []),
          f"{what}: verify accepted Ar and Krs of two proofs")
    log(f"{what} verify of Ar from one proof and Krs from another: False")
    fr = get_ff(curve.fr.name)
    ladder_sc = tuple(torch.as_tensor(fr.encode_words(s[g], mont=False),
                                      device=DEV) for g in ("g1", "g2"))
    return ladder_sc, (pk.g1_a, pk.g2_b), pk.g1_a[0].shape[0]


def phase_merkle(res):
    """merkle_d12: the Merkle membership example at depth 12 (N = 2^13,
    the radix-2 plan): setup, three proves, the third again on the scan
    path (the same proof; K6, jac_fold, K8 and K7 must launch, K4 and K9
    must not), verify; a wrong root fails."""
    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.backend.groth16_check import (Membership,
                                                       membership_assignment)
    from gnark_tpu_torch.frontend import compile_circuit, witness
    from gnark_tpu_torch.ntt.fourstep import fourstep_ntt
    from gnark_tpu_torch.ntt.radix2 import Radix2, butterfly, radix2_ntt
    t = time.perf_counter()
    cs = compile_circuit(Membership(MERKLE_DEPTH), fields.BN254_FR)
    pub, sec = witness(membership_assignment(MERKLE_DEPTH, 5), cs)
    log(f"merkle_d12: circuit {cs.summary()} and witness in "
        f"{time.perf_counter() - t:.2f} s")
    pk, vk, _ = timed_setup(cs, "merkle_d12")
    for wr in (radix2_ntt, butterfly, fourstep_ntt):
        wr.launches = 0
    calls = [0]
    plan_call = Radix2.__call__

    def counted(self, x, pre=None, post=None):
        calls[0] += 1
        return plan_call(self, x, pre, post)
    Radix2.__call__ = counted
    try:
        for i in range(3):
            tm = {}
            t = time.perf_counter()
            proof = groth16.prove(cs, pk, pub, sec,
                                  rng=random.Random(20 + i), timings=tm)
            tm["total"] = time.perf_counter() - t
            log(f"merkle_d12 prove {i} (s): {fmt_times(tm)}")
    finally:
        Radix2.__call__ = plan_call
    launches = {"radix2_ntt": radix2_ntt.launches,
                "butterfly": butterfly.launches,
                "fourstep_ntt": fourstep_ntt.launches, "transforms": calls[0]}
    log("launches during 3 merkle_d12 proves: " + json.dumps(launches) +
        f"; K5 launches a prove: {radix2_ntt.launches / 3:g} (91 before "
        f"the whole-transform kernel)")
    check(calls[0] > 0 and launches["fourstep_ntt"] == 0 and
          launches["butterfly"] == 0,
          "merkle_d12 proves did not take the radix-2 plan")
    check(0 < radix2_ntt.launches <= 2 * calls[0],
          f"merkle_d12: {radix2_ntt.launches} K5 launches for {calls[0]} "
          f"transforms, more than two a transform")
    res["radix2_ntt"]["launches"] = launches["radix2_ntt"]
    tm = {}

    def run():
        t = time.perf_counter()
        out = groth16.prove(cs, pk, pub, sec, rng=random.Random(22),
                            timings=tm)
        tm["total"] = time.perf_counter() - t
        return out
    proof_s, launches = scan_prove("merkle_d12", run)
    log(f"merkle_d12 scan-path prove (s): {fmt_times(tm)}")
    check(proof_s == proof, "merkle_d12: the scan-path proof differs from "
          "the bucket-path proof under the same rng")
    for k in ("jac_add", "jac_add_mixed", "jac_double", "jac_fold"):
        res[k]["launches"] = launches[k]
    log("merkle_d12 scan-path proof == bucket-path proof")
    t = time.perf_counter()
    check(groth16.verify(proof, vk, pub), "merkle_d12: verify rejected")
    log(f"merkle_d12 verify: True in {time.perf_counter() - t:.3f} s")
    q = pk.curve.fr.modulus
    check(not groth16.verify(proof, vk, [(pub[0] + 1) % q]),
          "merkle_d12: verify accepted a wrong root")
    log("merkle_d12 verify with a wrong root: False")


def phase_rc20(res):
    """rc_20: 2^17 secret 64-bit values range-checked through
    std/rangecheck (one BSB22 commitment): setup, a prove, verify (a
    second prove and the scan path, whose kernels g16_20's scan-path
    prove holds, are not run again here: they took ~55-65 s of the
    smoke's time limit); a proof with its commitment and PoK swapped,
    and one with a
    tampered PoK, do not verify."""
    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.backend.groth16_check import (
        RangeChecked, range_checked_assignment)
    from gnark_tpu_torch.ec import host
    from gnark_tpu_torch.frontend import compile_circuit, witness
    t = time.perf_counter()
    cs = compile_circuit(RangeChecked(RC_VALUES), fields.BN254_FR)
    t1 = time.perf_counter()
    pub, sec = witness(range_checked_assignment(RC_VALUES, 3), cs)
    check(len(cs.commitments) == 1, "rc_20: not one commitment")
    ncw = len(cs.commitments[0].committed_wires)
    log(f"rc_20: circuit {cs.summary()}, one commitment over {ncw} wires, "
        f"built in {t1 - t:.2f} s, witness in "
        f"{time.perf_counter() - t1:.2f} s")
    pk, vk, _ = timed_setup(cs, "rc_20")
    check(pk.domain_n == 1 << 20, f"rc_20: N = {pk.domain_n}, not 2^20")
    tm = {}
    t = time.perf_counter()
    proof = groth16.prove(cs, pk, pub, sec, rng=random.Random(31),
                          timings=tm)
    tm["total"] = time.perf_counter() - t
    log(f"rc_20 prove (s): {fmt_times(tm)}")
    t = time.perf_counter()
    check(groth16.verify(proof, vk, pub), "rc_20: verify rejected a proof")
    log(f"rc_20 verify: True in {time.perf_counter() - t:.3f} s")
    swapped = groth16.Proof(ar=proof.ar, krs=proof.krs, bs=proof.bs,
                            commitments=proof.poks, poks=proof.commitments)
    check(not groth16.verify(swapped, vk, pub),
          "rc_20: verify accepted a proof with commitment and PoK swapped")
    f1 = pk.curve.host_fp
    bad_pok = groth16.Proof(
        ar=proof.ar, krs=proof.krs, bs=proof.bs,
        commitments=proof.commitments,
        poks=[host.ec_add(f1, proof.poks[0], pk.curve.g1)])
    check(not groth16.verify(bad_pok, vk, pub),
          "rc_20: verify accepted a tampered PoK")
    log("rc_20 verify with commitment and PoK swapped: False; with a "
        "tampered PoK: False")


def sync():
    import torch
    if DEV != "cpu":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 6: kernels at their paths' shapes
# ---------------------------------------------------------------------------

def make_put(res, rate):
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
    put.res = res
    put.rate = rate
    return put


def phase_times(res, rng, n_pts, ladder_sc, key_cols, cv="bn254",
                n=1 << 20):
    """Each kernel of curve cv's builds at the shapes its path gives it
    (a domain of n; for K4 and K9 the g16_20 / g16_381_18 setup key's A
    (G1) and B (G2) columns, 2^20 + 2049 distinct points, with random
    scalars, at the main path's width, the grouping and the two passes
    also timed apart; a stage of 2^13 for K5, the G1 and G2 setup
    ladders' widths for K6 and K7, that setup's scalars for the ladder,
    the scan path's widest group-fold step for K8, K10-K14 at 2^20):
    timed, and held against its plain version on the same inputs (the
    ladder also against the per-bit K7 + K6 sequence on the card); a
    disagreement fails the run. BN254 also checks a 2^25 domain's round
    trip. A SHARED_FR curve (its scalar field on BN254's binaries) times
    its own point builds, K4 and K9 (no width sweep), the ladder and the
    affine kernel, and on its constants a 2^20 K2 transform and K14
    (times_shared_fr, in --quick, the other scalar-field kernels of its
    paths). A GROTH16_ONLY curve (BW6-761) times what its Groth16 path
    runs: K4 and K9 (the plain K4 on 2^12 points), the ladder (its plain
    time from phase 3, 16 rows against the host) and the affine kernel
    (the plain chain on 256 rows), and on its 12-word scalar field a 2^20
    K2 transform, K1 and mont_mul_sub_mul at 2^20."""
    import torch
    rate = int_mul_rate()
    put = make_put(res, rate)
    if cv in GROTH16_ONLY:
        times_k4_k9(res, rate, put, key_cols, cv, plain_pts=1 << 12)
        times_ladder(res, rate, put, ladder_sc, plain_rows=0, cv=cv,
                     per_bit=False, affine_rows=256)
        torch.cuda.empty_cache()
        times_fourstep(res, put, rng, n, cv)
        times_mont_mul(put, rng, n, cv)
        times_computeh(res, put, rng, n, cv)
        return
    if cv in SHARED_FR:
        times_k4_k9(res, rate, put, key_cols, cv)
        times_ladder(res, rate, put, ladder_sc, plain_rows=0, cv=cv)
        torch.cuda.empty_cache()
        times_fourstep(res, put, rng, n, cv)
        times_numerator(res, put, rng, n, cv)
        return
    times_k1_k3(put, rng, n, cv)
    times_k4_k9(res, rate, put, key_cols, cv)
    sweep_widths(key_cols, cv)

    times_k5(res, put, rng, cv)
    times_computeh(res, put, rng, n, cv)
    if cv == "bn254":
        round_trip(1 << 25, rng)

    times_k6_k7(put, ladder_sc, cv)
    times_ladder(res, rate, put, ladder_sc, plain_rows=0, cv=cv)
    torch.cuda.empty_cache()

    times_k8(put, n_pts, cv)
    times_ff_ops(res, put, rng, n, cv)


def times_k1_k3(put, rng, n, cv="bn254"):
    """K1 and K2's row kernel at a domain of n, the whole four-step
    transform (times_fourstep), and K3 at the shapes of the bucket
    epilogue that K9 replaced."""
    import torch
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ec.proj_ec import (proj_add, proj_add_plain,
                                            proj_double, proj_double_plain)
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.msm.bucket import group_b3
    from gnark_tpu_torch.ntt.fourstep import (root_powers, row_fft,
                                              row_fft_plain, row_plan,
                                              seg_table)
    c = curves.CURVES[cv]
    fr = get_ff(c.fr.name)
    res = put.res
    times_mont_mul(put, rng, n, cv)
    S = 1 << (n.bit_length() // 2)                 # row length, as FourStep
    x = rand_words(fr, n, rng).reshape(n // S, S, 8)
    pw = torch.as_tensor(root_powers(fr, S, fr.p.root_of_unity(S)),
                         device=DEV)
    tw = seg_table(pw, S.bit_length() - 1, row_plan(S)[1])
    ms, got = timed(lambda: row_fft(fr, x, pw, tw))
    pms, want = timed(lambda: row_fft_plain(fr, x, pw), 3)
    put("row_fft", "", [n // S, S, 8], ms, pms,
        2 * n * 32 + pw.numel() * 4,
        n // 2 * (S.bit_length() - 1) * MUL_OPS["mul"], max_abs(got, want))
    del x, got, want
    times_fourstep(res, put, rng, n, cv)
    # K3 at the shapes of the bucket epilogue that K9 replaced on the main
    # path (its widest suffix-sum step at c = 8, W * B/2 pairs, and its
    # one-point Horner adds and doubles)
    fp = get_ff(c.fp.name)
    ops = mul_ops(fp.nw)
    b3 = group_b3(c)
    wide = 32 * 128 // 2
    for name, sfx, w, fn, pfn, k, nin in (
            ("proj_add", "", wide, proj_add, proj_add_plain, "proj_add", 6),
            ("proj_add", "_1", 1, proj_add, proj_add_plain, "proj_add", 6),
            ("proj_double", "", 1, proj_double, proj_double_plain,
             "proj_dbl", 3)):
        P = tuple(rand_words(fp, w, rng, lazy=w // 4) for _ in range(nin))
        args = (P[:3], P[3:]) if nin == 6 else (P,)
        ms, got = timed(lambda: fn(fp, b3, *args))
        pms, want = timed(lambda: pfn(fp, b3, *args), 3)
        put(name, sfx, [w, fp.nw], ms, pms, (nin + 3) * w * 4 * fp.nw,
            w * ops[k], max(max_abs(u, v) for u, v in zip(got, want)))


def times_shared_fr(res, rng, cv, n=1 << 20):
    """The scalar-field kernels of a SHARED_FR curve's paths that its
    phase 6 leaves out (BN254's binaries on its constants), at their
    paths' shapes against their plain versions: K1, K5, mont_mul_sub_mul
    and K10-K13."""
    put = make_put(res, int_mul_rate())
    times_mont_mul(put, rng, n, cv)
    times_k5(res, put, rng, cv)
    times_computeh(res, put, rng, n, cv)
    times_ff_ops(res, put, rng, n, cv, two_n=False, numerator=False)


def times_mont_mul(put, rng, n, cv="bn254"):
    """K1's product over a domain of n of curve cv's scalar field."""
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain
    fr = get_ff(f"{cv}_fr")
    a, b = rand_words(fr, n, rng), rand_words(fr, n, rng)
    ms, got = timed(lambda: mont_mul(fr, a, b))
    pms, want = timed(lambda: mont_mul_plain(fr, a, b), 3)
    put("mont_mul", "", [n, fr.nw], ms, pms, 3 * n * 4 * fr.nw,
        n * mul_ops(fr.nw)["mul"], max_abs(got, want))


def times_k8(put, n_pts, cv="bn254"):
    """K8 at the scan path's widest shape before the group fold became
    one launch (the first halving step of a wire MSM's fold: W * G/2 *
    2^c rows for n_pts points; now the widest K8 step is a suffix
    sum's); the plain version on the first 2^16 rows, against the kernel
    on the same slice; then the fold itself at that MSM's shape."""
    import torch
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ec.jac_ec import jac_add, jac_add_plain
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.msm.pippenger import _pick_params
    from gnark_tpu_torch.ec.proj_ec import _lw
    c = curves.CURVES[cv]
    nw = get_ff(c.fp.name).nw
    ops = mul_ops(nw)
    gen_t = torch.Generator(device=DEV).manual_seed(5)
    n_class = 1 << (n_pts - 1).bit_length()
    cc, G = _pick_params(n_class, c.fr.bits)
    W = -(-c.fr.bits // cc)
    wide = W * (G // 2) << cc
    for g2 in (False, True):
        ff = group_ff(c, g2)
        Lw = _lw(ff)
        P = tuple(rand_dev_words(wide, Lw, gen_t, nw, c.fp.modulus)
                  for _ in range(6))
        pn = 1 << 16
        sl_ = tuple(a[:pn] for a in P)
        op, sfx = ("2" if is_fp2(ff) else "", "_g2" if g2 else "")
        ms, _ = timed(lambda: jac_add(ff, P[:3], P[3:]))
        pms, want = timed(lambda: jac_add_plain(ff, sl_[:3], sl_[3:]), 1,
                          warm=False)
        got = jac_add(ff, sl_[:3], sl_[3:])
        put("jac_add", sfx, [wide, Lw], ms, pms, wide * 9 * Lw * 4,
            wide * ops["jac_add" + op],
            max(max_abs(u, v) for u, v in zip(got, want)),
            plain_shape=[min(pn, wide), Lw])
        del P, sl_, got, want
        torch.cuda.empty_cache()
        times_fold(put, ff, Lw, op, sfx, W, G, 1 << cc, gen_t, ops=ops,
                   nw=nw)


def times_fold(put, ff, Lw, op, sfx, W, G, B, gen_t, plain_cols=1024,
               ops=MUL_OPS, nw=8):
    """jac_fold at a wire MSM's fold (W windows, G groups, B buckets, W *
    G * B rows in, W * B out) on random words, timed beside the halving
    tree of K8 that it replaced (log2 G launches and a stack of the
    buckets after each; on random words, which are no curve points, the
    two orders give other values: phase 3 holds them equal on points).
    The plain twin on the first plain_cols buckets of the first window
    (their G rows), against the kernel on the same slice. Bound: (G - 1)
    adds a column, the rows read and the columns written once."""
    import torch
    from gnark_tpu_torch.ec.jac_ec import jac_add, jac_fold, jac_fold_plain
    N = W * G * B
    P = tuple(rand_dev_words(N, Lw, gen_t, nw, ff.p.modulus)
              for _ in range(3))
    ms, got = timed(lambda: jac_fold(ff, P, G, B), 3)

    def tree():
        T = torch.stack(P).reshape(3, W, G, B, Lw)
        g = G
        while g > 1:
            h = g // 2
            R = jac_add(ff, tuple(a.reshape(-1, Lw) for a in T[:, :, :h]),
                        tuple(a.reshape(-1, Lw) for a in T[:, :, h:g]))
            T = torch.stack(R).reshape(3, W, h, B, Lw)
            g = h
        return T[:, :, 0].reshape(3, W * B, Lw)
    tree_ms, _ = timed(tree, 1)
    sl_ = tuple(a.reshape(W, G, B, Lw)[:1, :, :plain_cols].reshape(-1, Lw)
                .contiguous() for a in P)
    pms, want = timed(lambda: jac_fold_plain(ff, sl_, G, plain_cols), 1,
                      warm=False)
    got = jac_fold(ff, sl_, G, plain_cols)
    put("jac_fold", sfx, [N, Lw, G], ms, pms, (N + W * B) * 3 * Lw * 4,
        (G - 1) * W * B * ops["jac_add" + op],
        max(max_abs(u, v) for u, v in zip(got, want)),
        plain_shape=[G * plain_cols, Lw, G])
    res_fold = put.res["jac_fold"]
    res_fold["tree_ms" + sfx] = tree_ms
    log(f"jac_fold {ff.p.name}{sfx} at W = {W}, G = {G}, B = {B}: "
        f"{ms:.3f} ms; the "
        f"halving tree of K8 it replaced {tree_ms:.3f} ms")
    del P, sl_, got, want
    torch.cuda.empty_cache()


def times_fourstep(res, put, rng, n, cv="bn254"):
    """A whole 2^n transform (fourstep_ntt, two launches with the
    scalings and the mid twiddle inside) against its plain twin and
    against the sequence of launches it replaced, run here on the same
    inputs and on the current row kernel: K1 for a scaling, a transpose,
    row_fft, K1 for the mid twiddle, a transpose, row_fft, two gathers
    and a transpose (K1 for an iFFT's n^-1 after). Coset FFT (a
    pre-scale vector) and iFFT (n^-1 broadcast). bound_ms: an n-point
    NTT's own work, n/2 log2 n products and n for the scaling, the
    input, output and scaling vector moved once. bound_ms_fourstep: the
    four-step split's work, that plus n products for the mid twiddle
    and its table read once."""
    import torch
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ff.mont_mul import mont_mul
    from gnark_tpu_torch.ntt import get_domain
    from gnark_tpu_torch.ntt.fourstep import (bitrev, fourstep_ntt,
                                              fourstep_ntt_plain, row_fft)
    fr = get_ff(f"{cv}_fr")
    nw, M = fr.nw, mul_ops(fr.nw)["mul"]
    dom = get_domain(fr, n, DEV)
    x = rand_words(fr, n, rng)
    for inv, sfx in ((False, ""), (True, "_ifft")):
        plan = dom._plan(inv)
        S, n1 = plan.S, plan.n1
        pre = None if inv else dom._coset
        post = dom._ninv if inv else None
        mid = plan.mid_t.reshape(S, n1, nw).permute(1, 0, 2).contiguous()
        rS = torch.as_tensor(bitrev(S), device=DEV)
        rn = torch.as_tensor(bitrev(n1), device=DEV)

        def sequence():
            y = mont_mul(fr, x, pre) if pre is not None else x
            A = y.reshape(S, n1, nw).permute(1, 0, 2).contiguous()
            Z = mont_mul(fr, row_fft(fr, A, plan.pw[0], plan.tw[0]), mid)
            W = row_fft(fr, Z.permute(1, 0, 2).contiguous(), plan.pw[1],
                        plan.tw[1])
            D = W.index_select(0, rS).permute(1, 0, 2).index_select(0, rn)
            D = D.reshape(n, nw)
            return mont_mul(fr, D, post) if post is not None else D
        before = fourstep_ntt.launches
        ms, got = timed(lambda: fourstep_ntt(plan, x, pre, post))
        per = (fourstep_ntt.launches - before) // 6
        check(per == 2, f"fourstep_ntt 2^{n.bit_length() - 1}: {per} "
              f"launches a transform")
        seq_ms, want = timed(sequence)
        check(torch.equal(got, want), f"fourstep_ntt{sfx} differs from the "
              f"row_fft + K1 sequence")
        pms, want = timed(lambda: fourstep_ntt_plain(plan, x, pre, post), 1,
                          warm=False)
        prods = n // 2 * (n.bit_length() - 1) + n
        eb = 4 * nw                                 # bytes an element
        nbytes = 2 * n * eb + (n * eb if pre is not None else eb)
        put("fourstep_ntt", sfx, [n, nw], ms, pms, nbytes, prods * M,
            max_abs(got, want))
        b, by = bound_ms(nbytes + n * eb, (prods + n) * M, put.rate)
        res["fourstep_ntt"].update({"sequence_ms" + sfx: seq_ms,
                                    "bound_ms_fourstep" + sfx: b,
                                    "bound_by_fourstep" + sfx: by})
        log(f"fourstep_ntt {cv} {'iFFT' if inv else 'coset FFT'} 2^"
            f"{n.bit_length() - 1}: {ms:.4f} ms in 2 launches (four-step "
            f"bound {b:.4f} ms, {by}); the row_fft + K1 + transposes + "
            f"gathers sequence it replaced, on the current row kernel, "
            f"{seq_ms:.4f} ms, the same words")
    del x, got, want


def round_trip(n, rng):
    """A 2^25 domain (rows of 2^13: a global pass, then two shared-memory
    segments) on the card: ifft(fft(x)) == x and ifft(fft(x, coset),
    coset) == x, on random x; the K2 launches, the times and the
    domain's build time logged. Before fourstep.row_plan, rows past a
    block's shared memory made this transform raise."""
    import torch
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ntt import Domain
    from gnark_tpu_torch.ntt.fourstep import fourstep_ntt
    fr = get_ff("bn254_fr")
    t = time.perf_counter()
    dom = Domain(fr, n, DEV)
    sync()
    build = time.perf_counter() - t
    gen_t = torch.Generator(device=DEV).manual_seed(9)
    x = rand_dev_words(n, 8, gen_t)
    times = {}
    for coset in (False, True):
        before = fourstep_ntt.launches
        ms_f, y = timed(lambda: dom.fft(x, coset=coset), 1, warm=False)
        ms_i, z = timed(lambda: dom.ifft(y, coset=coset), 1, warm=False)
        k = fourstep_ntt.launches - before
        check(torch.equal(z, x), f"2^{n.bit_length() - 1} round trip "
              f"(coset={coset}) did not give x back")
        times[f"coset={coset}"] = {"fft_ms": ms_f, "ifft_ms": ms_i,
                                   "launches": k}
        del y, z
    log(f"round trip at 2^{n.bit_length() - 1} (plans "
        f"{dom._plan(False).rplan}): ifft(fft(x)) == x, plain and coset; "
        f"{json.dumps(times)}; domain built in {build:.1f} s")
    del dom, x
    torch.cuda.empty_cache()


def times_k5(res, put, rng, cv="bn254"):
    """One whole K5 transform of merkle_d12's 2^13 domain against its
    plain version, and against the sequence it replaced (the gather and
    13 one-stage launches), timed beside it."""
    import numpy as np
    import torch
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ntt.fourstep import bitrev
    from gnark_tpu_torch.ntt.radix2 import (butterfly, radix2_ntt,
                                            radix2_ntt_plain, stage_twiddles)
    fr = get_ff(f"{cv}_fr")
    m = 1 << 13
    x = rand_words(fr, m, rng)
    tw = torch.as_tensor(np.concatenate(stage_twiddles(
        fr, m, fr.p.root_of_unity(m))), device=DEV)
    ms, got = timed(lambda: radix2_ntt(fr, x, tw))
    pms, want = timed(lambda: radix2_ntt_plain(fr, x, tw), 3)
    put("radix2_ntt", "", [m, 8], ms, pms, 2 * m * 32 + tw.numel() * 4,
        m // 2 * (m.bit_length() - 1) * MUL_OPS["mul"], max_abs(got, want))
    rev = torch.as_tensor(bitrev(m), device=DEV)
    stages = [tw[(1 << s) - 1:(2 << s) - 1] for s in range(13)]

    def per_stage():
        y = x.index_select(0, rev)
        for t in stages:
            butterfly(fr, y, t)
        return y
    res["radix2_ntt"]["per_stage_ms"], want = timed(per_stage)
    check(torch.equal(got, want), "radix2_ntt differs from the per-stage "
          "K5 sequence")
    log(f"radix2_ntt {cv} 2^13: {ms:.4f} ms; the gather and 13 one-stage "
        f"launches it replaced {res['radix2_ntt']['per_stage_ms']:.4f} ms, "
        f"the same words")


def times_computeh(res, put, rng, n, cv="bn254"):
    """computeH of a 2^n-point prove, part by part, on random inputs: an
    iFFT, a coset FFT, the pointwise (a*b - c)*den as the fused
    mont_mul_sub_mul (timed against its plain version and its bound),
    and as it ran before this kernel (K1, a plain int64-limb subtract,
    K1; and that subtract alone), the coset iFFT and the K1 out of
    Montgomery form."""
    import torch
    from gnark_tpu_torch.ff import get_ff, on_words
    from gnark_tpu_torch.ff.mont_mul import (mont_mul, mont_mul_sub_mul,
                                             mont_mul_sub_mul_plain)
    from gnark_tpu_torch.ntt import get_domain
    fr = get_ff(f"{cv}_fr")
    dom = get_domain(fr, n, DEV)
    a, b, c = (rand_words(fr, n, rng) for _ in range(3))
    d = rand_words(fr, 1, rng)
    one = raw_words([1], fr.nw)
    ms, got = timed(lambda: mont_mul_sub_mul(fr, a, b, c, d))
    pms, want = timed(lambda: mont_mul_sub_mul_plain(fr, a, b, c, d), 3)
    put("mont_mul_sub_mul", "", [n, fr.nw], ms, pms, (4 * n + 1) * 4 * fr.nw,
        n * 2 * mul_ops(fr.nw)["mul"], max_abs(got, want))
    parts = {
        "ifft": cuda_ms(lambda: dom.ifft(a)),
        "coset_fft": cuda_ms(lambda: dom.fft(a, coset=True)),
        "pointwise": ms,
        "pointwise_before": cuda_ms(lambda: mont_mul(fr, on_words(
            fr, "sub", mont_mul(fr, a, b), c), d)),
        "plain_sub": cuda_ms(lambda: on_words(fr, "sub", a, c)),
        "coset_ifft": cuda_ms(lambda: dom.ifft(a, coset=True)),
        "from_mont": cuda_ms(lambda: mont_mul(fr, a, one))}
    parts["computeH"] = 3 * (parts["ifft"] + parts["coset_fft"]) + \
        parts["pointwise"] + parts["coset_ifft"] + parts["from_mont"]
    res["mont_mul_sub_mul"]["computeH_parts_ms"] = parts
    log(f"computeH {cv} at 2^{n.bit_length() - 1}, ms by part (CUDA events; "
        f"computeH = 3 (ifft + coset_fft) + pointwise + coset_ifft + "
        f"from_mont): {json.dumps(parts)}")


def times_k6_k7(put, ladder_sc, cv="bn254"):
    """K6 and K7 at the g16_20 setup ladders' widths on random words;
    the plain versions on the first 2^16 points, against the kernels on
    the same slice."""
    import torch
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ec.jac_ec import (jac_add_mixed,
                                           jac_add_mixed_plain, jac_double,
                                           jac_double_plain)
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.ec.proj_ec import _lw
    c = curves.CURVES[cv]
    nw = get_ff(c.fp.name).nw
    ops = mul_ops(nw)
    gen_t = torch.Generator(device=DEV).manual_seed(5)
    for g2, sc in ((False, ladder_sc[0]), (True, ladder_sc[1])):
        npts = sc.shape[0]
        ff = group_ff(c, g2)
        Lw = _lw(ff)
        P = tuple(rand_dev_words(npts, Lw, gen_t, nw, c.fp.modulus)
                  for _ in range(3))
        bx, by = affine_words(ff, [c.g2 if g2 else c.g1])
        mask = torch.rand(npts, device=DEV, generator=gen_t) < 0.5
        pn = 1 << 16
        sl_ = tuple(a[:pn] for a in P)
        op, sfx = ("2" if is_fp2(ff) else "", "_g2" if g2 else "")
        for name, fn, pfn, args, k, nbytes in (
                ("jac_add_mixed", jac_add_mixed, jac_add_mixed_plain,
                 (bx, by, mask), "jac_madd",
                 npts * (6 * Lw * 4 + 1) + 2 * Lw * 4),
                ("jac_double", jac_double, jac_double_plain, (), "jac_dbl",
                 npts * 6 * Lw * 4)):
            a_sl = tuple(a[:pn] for a in args[2:]) if args else ()
            ms, _ = timed(lambda: fn(ff, P, *args))
            pms, want = timed(lambda: pfn(ff, sl_, *args[:2], *a_sl), 1,
                              warm=False)
            got = fn(ff, sl_, *args[:2], *a_sl)
            put(name, sfx, [npts, Lw], ms, pms, nbytes,
                npts * ops[k + op],
                max(max_abs(u, v) for u, v in zip(got, want)),
                plain_shape=[min(pn, npts), Lw])
        del P, sl_, got, want


def table_window(n, nbits):
    """The window w (1..24) at which a fixed-base table takes the fewest
    mixed adds for n scalars of nbits bits: the table holds d 2^(w j) B
    for each of the k = ceil(nbits / w) windows j and each digit d in
    1..2^w - 1, built once (one add a point); then a scalar takes one
    table point a nonzero digit, k - 1 adds at most, and no doubling."""
    return min(range(1, 25), key=lambda w: n * (-(-nbits // w) - 1) +
               -(-nbits // w) * ((1 << w) - 1))


def ladder_work(sc, nbits, w):
    """What these scalars need, counted on the card: (doublings, adds)
    of double-and-add over the low nbits bits (a nonzero scalar doubles
    once for each bit below its top bit and adds once for each set bit
    below it), and the mixed adds a table at window w takes (one fewer
    than its nonzero digits)."""
    import torch
    w32 = sc.to(torch.int64) & 0xFFFFFFFF
    n = sc.shape[0]
    pop = torch.zeros(n, dtype=torch.int64, device=sc.device)
    top = torch.full_like(pop, -1)
    digits = torch.zeros(n, -(-nbits // w), dtype=torch.int64,
                         device=sc.device)
    for b in range(nbits):
        bit = (w32[:, b // 32] >> (b % 32)) & 1
        pop += bit
        top = torch.where(bit == 1, b, top)
        digits[:, b // w] |= bit
    return (int(top.clamp(min=0).sum()), int((pop - 1).clamp(min=0).sum()),
            int((digits.sum(1) - 1).clamp(min=0).sum()))


def times_ladder(res, rate, put, ladder_sc, plain_rows=1024, cv="bn254",
                 per_bit=True, affine_rows=1024):
    """The ladder on the g16_20 setup's G1 and G2 scalars, held bit-exact
    against its plain version on the first plain_rows of them (whose
    time is the plain time; plain_rows 0: the plain version's time on
    phase 3's scalars, already held bit-exact there, whose plain ladder
    is dispatch-bound and takes as long at any width) and against the
    per-bit K7 + K6 sequence it fuses on all of them (timed beside it;
    without per_bit, the first 16 rows against host multiplications
    instead); then the affine kernel on its output (times_affine, the
    plain chain on affine_rows).
    Bound: the least work of the function, a fixed-base [s] B of which
    Setup keeps the affine point: a
    table at the best window (table_window), its mixed adds for these
    scalars' nonzero digits plus one a table point, its bytes written
    and read once. bound_ms_dbl_add: the doublings and adds that
    double-and-add needs for these scalars, as the kernel runs it."""
    import torch
    from gnark_tpu_torch.ec import curves, host
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.msm.fixed_base import (batch_scalar_mul,
                                                batch_scalar_mul_plain,
                                                per_bit_ladder)
    from gnark_tpu_torch.ec.proj_ec import _lw
    c = curves.CURVES[cv]
    nbits = c.fr.bits
    ops = mul_ops(get_ff(c.fp.name).nw)
    r = res["batch_scalar_mul"]
    for g2, sc in ((False, ladder_sc[0]), (True, ladder_sc[1])):
        ff = group_ff(c, g2)
        base = affine_words(ff, [c.g2 if g2 else c.g1])
        n, Lw = sc.shape[0], _lw(ff)
        op, sfx = ("2" if is_fp2(ff) else "", "_g2" if g2 else "")
        # BW6-761's ladder runs for seconds: one timed run, not a warm one
        # and three (~35 s of the time limit)
        ms, got = timed(lambda: batch_scalar_mul(ff, base, nbits, sc),
                        *((3,) if per_bit else (1, False)))
        if plain_rows:
            pms, want = timed(lambda: batch_scalar_mul_plain(
                ff, base, nbits, sc[:plain_rows]), 1, warm=False)
            err = max(max_abs(u[:plain_rows], v) for u, v in zip(got, want))
            pshape = [min(plain_rows, n), Lw, nbits]
        else:
            (pms, pshape), err = r["phase3_plain" + sfx], 0
        if per_bit:
            seq_ms, want = timed(lambda: per_bit_ladder(ff, base, nbits, sc),
                                 1)
            check(all(torch.equal(u, v) for u, v in zip(got, want)),
                  f"ladder {'G2' if g2 else 'G1'} differs from the per-bit "
                  f"K7 + K6 on the setup's scalars")
            del want
        else:
            seq_ms = None
            hf, gen = (c.host_g2_field, c.g2) if g2 else (c.host_fp, c.g1)
            ks = get_ff(c.fr.name).decode_words(sc[:16].cpu(), mont=False)
            for i, k in enumerate(ks):
                check(jac_to_host(ff, hf, got, i) ==
                      host.ec_mul(hf, gen, int(k)),
                      f"ladder {'G2' if g2 else 'G1'} row {i} of the setup's "
                      f"scalars != [s] G")
        times_affine(res, rate, put, ff, got, g2, plain_rows=affine_rows,
                     ops=ops)
        del got
        w = table_window(n, nbits)
        tab = -(-nbits // w) * ((1 << w) - 1)
        dbls, adds, tab_adds = ladder_work(sc, nbits, w)
        dbl_ops, add_ops = ops["jac_dbl" + op], ops["jac_madd" + op]
        put("batch_scalar_mul", sfx, [n, Lw, nbits], ms, pms,
            n * (4 * sc.shape[1] + 3 * Lw * 4) + 2 * tab * 2 * Lw * 4,
            (tab_adds + tab) * add_ops, err, plain_shape=pshape)
        dbl_add = bound_ms(0, dbls * dbl_ops + adds * add_ops, rate)[0]
        r.update({"per_bit_ms" + sfx: seq_ms, "bound_ms_dbl_add" + sfx: dbl_add,
                  "work" + sfx: {"table_w": w, "table_points": tab,
                                 "table_adds": tab_adds, "dbl": dbls,
                                 "add": adds}})
        log(f"ladder {cv} {'G2' if g2 else 'G1'} on {n} setup scalars: "
            f"{ms:.3f} ms; " + (f"the per-bit K7 + K6 sequence {seq_ms:.3f} "
                                f"ms, the same words" if per_bit else
                                "16 rows equal host multiplications") +
            f"; the words of the plain version on "
            f"{pshape[0]}; bound {r['bound_ms' + sfx]:.3f} ms for a "
            f"table at w = {w} ({tab} points, {tab_adds} adds); "
            f"double-and-add {dbl_add:.3f} ms ({dbls} doublings, {adds} "
            f"adds)")


def times_affine(res, rate, put, ff, P, g2, plain_rows=1024, ops=MUL_OPS):
    """K1's affine kernel on Setup's Jacobian points P (the ladder's
    output on the setup's scalars), held bit-exact against its plain
    version, the Fermat chain of plain products, on the first plain_rows
    (whose time is the plain time). Bound: the chain's operations as the
    Bound: the least work of the function, as the kernel does it:
    Montgomery's batch inversion (three products a point and one inverse
    for the batch) and the affine products, against the bytes of X, Y,
    Z read and x, y written once. bound_ms_fermat: a Fermat inverse a
    point (the reference's, the bits of p - 2: squarings and products)
    and the same affine products. chain_ms: the sequence the kernel
    replaced, the
    same chain with each squaring and product one K1 launch over the
    batch (its words must equal the kernel's on all of P)."""
    import torch
    from gnark_tpu_torch.ff.mont_mul import mont_mul
    from gnark_tpu_torch.msm import fixed_base
    n, Lw = P[0].shape
    ms, got = timed(lambda: fixed_base.affine_words(ff, P), 3)
    sl = tuple(a[:plain_rows] for a in P)
    pms, want = timed(lambda: fixed_base.affine_words_plain(ff, sl), 1,
                      warm=False)
    err = max(max_abs(u[:plain_rows], v) for u, v in zip(got, want))
    plain_mul = fixed_base.mont_mul_plain
    fixed_base.mont_mul_plain = mont_mul
    try:
        chain_ms, want = timed(lambda: fixed_base.affine_words_plain(ff, P),
                               1)
    finally:
        fixed_base.mont_mul_plain = plain_mul
    check(all(torch.equal(u, v) for u, v in zip(got, want)),
          f"affine_words {'G2' if g2 else 'G1'} differs from the K1 chain "
          f"on the setup's points")
    del want
    e = ff.p.modulus - 2
    M, S = ops["mul"], ops["sqr"]
    chain = (e.bit_length() - 1) * S + (bin(e).count("1") - 1) * M
    if is_fp2(ff):   # norm 2S, zi 2M; zi^2 an Fp2 S, zi^3, x, y 3 Fp2 M
        per = 2 * S + 2 * M + 2 * M + 3 * 3 * M
    else:        # zi^2 S; zi^3, x, y 3M
        per = S + 3 * M
    sfx = "_g2" if g2 else ""
    nbytes = n * 5 * Lw * 4
    # batch inversion: three products a point (the prefix, two back)
    put("affine_words", sfx, [n, Lw], ms, pms, nbytes,
        n * (per + 3 * M) + chain, err, plain_shape=[min(plain_rows, n), Lw])
    b, by = bound_ms(nbytes, n * (per + chain), rate)
    res["affine_words"].update({"bound_ms_fermat" + sfx: b,
                                "bound_by_fermat" + sfx: by,
                                "chain_ms" + sfx: chain_ms})
    log(f"affine_words {ff.p.name} {'G2' if g2 else 'G1'} on {n} setup "
        f"points: "
        f"{ms:.3f} ms; the K1 chain it replaced {chain_ms:.3f} ms, the "
        f"same words; a Fermat inverse a point would be bound at {b:.4f} "
        f"ms ({by})")


def k9_work(W, c):
    """(adds, doublings) that the function of K9 needs at width c over W
    windows, whatever the kernel's own decomposition: two adds a bucket
    (a running sum and a weighted sum), then Horner over the windows."""
    return 2 * (W << (c - 1)) + W - 1, c * (W - 1)


def times_k4_k9(res, rate, put, key_cols, cv="bn254", plain_pts=1 << 16):
    """K4 (the digit kernel, the grouping, pass 1 and pass 2 timed apart)
    and K9 on the g16_20 setup key's A and B columns with random scalars,
    at the main path's width. The plain K4 runs on the first plain_pts
    points (against the kernel on the same slice)."""
    import torch
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.msm.bucket import (
        _flat_points, bucket_acc, bucket_digits, bucket_fold, group_b3,
        bucket_group, bucket_msm, bucket_msm_plain, bucket_reduce,
        bucket_reduce_plain, signed_digits)
    from gnark_tpu_torch.msm.pippenger import scalar_limbs
    c = curves.CURVES[cv]
    nbits, fpn = c.fr.bits, c.fp.name
    ops = mul_ops(get_ff(fpn).nw)
    sw = get_ff(c.fr.name).nw                     # a scalar's words
    gen_t = torch.Generator(device=DEV).manual_seed(6)
    for g2, col in ((False, key_cols[0]), (True, key_cols[1])):
        ff = group_ff(c, g2)
        b3 = group_b3(c, g2)
        x, y, inf = _flat_points(ff, col)
        n, Lw = x.shape
        sc = rand_dev_words(n, sw, gen_t, sw, c.fr.modulus)
        op, gs = ("2" if is_fp2(ff) else "", "_g2" if g2 else "")
        # at the path's width only (c = 8's plain K4 and K9 took ~30 s a
        # curve of the time limit; phase 3 holds c = 8 on 4,096 points)
        for cc, cs in ((C_MAIN, ""),):
            sfx = cs + gs
            if not g2:
                ms, digits = timed(lambda: bucket_digits(sc, nbits, cc, fpn))
                pms, want = timed(lambda: signed_digits(scalar_limbs(sc),
                                                        nbits, cc), 3)
                W = digits.shape[0]
                put("bucket_digits", cs, [n, sw], ms, pms,
                    n * 4 * sw + W * n * 4,
                    0, 0 if torch.equal(digits, want) else 1)
            digits = bucket_digits(sc, nbits, cc, fpn)
            W, B = digits.shape[0], 1 << (cc - 1)
            grp = bucket_group(digits, inf, cc, fpn)
            part = bucket_acc(ff, b3, x, y, grp)
            split = {"group_ms": cuda_ms(lambda: bucket_group(digits, inf,
                                                              cc, fpn)),
                     "pass1_ms": cuda_ms(lambda: bucket_acc(ff, b3, x, y,
                                                            grp)),
                     "pass2_ms": cuda_ms(lambda: bucket_fold(ff, b3, grp,
                                                             part))}
            del part
            ms, got = timed(lambda: bucket_msm(ff, b3, x, y, inf, digits,
                                               cc))
            pairs, nseg = int(grp.counts.sum()), int(grp.seg_off[-1])
            nmul = (pairs - nseg) * ops["proj_madd" + op] + \
                nseg * ops["proj_add" + op]
            nbytes = n * (2 * Lw * 4 + 1) + W * n * 4 + pairs * 8 + \
                W * B * (3 * Lw * 4 + 12)
            pn = plain_pts
            sl_ = (x[:pn], y[:pn], inf[:pn], digits[:, :pn])
            pms, want = timed(lambda: bucket_msm_plain(ff, b3, *sl_, cc), 1,
                              warm=False)
            ref = bucket_msm(ff, b3, *sl_, cc)
            put("bucket_msm", sfx, [n, Lw, cc], ms, pms, nbytes, nmul,
                proj_err(ff, ref, want), plain_shape=[pn, Lw, cc])
            res["bucket_msm"]["split" + sfx] = split
            log(f"bucket_msm {cv}{sfx} split: {json.dumps(split)}; {pairs} "
                f"pairs, {nseg} segments")
            del want, ref, grp
            # K9 on these bucket sums
            ms, R = timed(lambda: bucket_reduce(ff, b3, got, W, cc))
            pms, Rp = timed(lambda: bucket_reduce_plain(ff, b3, got, W, cc),
                            1, warm=False)
            adds, dbls = k9_work(W, cc)
            put("bucket_reduce", sfx, [W * B, Lw, cc], ms, pms,
                W * B * 3 * Lw * 4 + 3 * Lw * 4,
                adds * ops["proj_add" + op] +
                dbls * ops["proj_dbl" + op], proj_err(ff, R, Rp))
            del got
        torch.cuda.empty_cache()


SWEEP_C = (8, 10, 12, 13, 14, 16)


def sweep_widths(key_cols, cv="bn254"):
    """The whole bucket MSM (digit kernel, K4, K9), as a prove calls it,
    at each width of SWEEP_C (through GNARK_TPU_MSM_C) on the g16_20
    setup key's A (G1) and B (G2) columns and on their first 2^16 and
    2^13 points, with random scalars: median of 3 by CUDA events. The
    table msm/bucket._CARD_C comes from it. The widths' results must be
    one group element."""
    import torch
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.ff import get_ff
    from gnark_tpu_torch.msm.bucket import group_b3, msm_proj, window_bits
    c = curves.CURVES[cv]
    gen_t = torch.Generator(device=DEV).manual_seed(8)
    for g2, col in ((False, key_cols[0]), (True, key_cols[1])):
        ff = group_ff(c, g2)
        n0 = col[0].shape[0]
        sw = get_ff(c.fr.name).nw
        sc = rand_dev_words(n0, sw, gen_t, sw, c.fr.modulus)
        for n in (n0, 1 << 16, 1 << 13):
            pts = tuple(a[:n] for a in col)
            row, first = {}, None
            for cc in SWEEP_C:
                with setenv("GNARK_TPU_MSM_C", str(cc)):
                    row[cc], R = timed(lambda: msm_proj(
                        ff, pts, sc[:n], c.fr.bits, b3=group_b3(c, g2)), 3)
                first = first or R
                check(proj_err(ff, R, first) == 0,
                      f"bucket MSM at c = {cc} differs from c = "
                      f"{SWEEP_C[0]} ({n} points)")
            log(f"bucket MSM width sweep, {cv} {'G2' if g2 else 'G1'}, {n} "
                f"points, ms by c: {json.dumps(row)}; best c = "
                f"{min(row, key=row.get)}, default c = "
                f"{window_bits(n, DEV)}; one group element at every c")
        del sc
        torch.cuda.empty_cache()


def rand_dev_words(n, lw, gen, nw=8, q=None):
    """(n, lw) random words made on the card; the top word of each
    nw-word element is cut below 0x30000000 (8 words: < p for both BN254
    fields and BLS12-381's scalar field) or 0x10000000 (12 words: < p for
    BLS12-381's base field), that mask halved while it is not below the
    top word of q, the modulus if given (BLS12-377's fields)."""
    import torch
    w = torch.randint(-2 ** 31, 2 ** 31, (n, lw), dtype=torch.int64,
                      device=DEV, generator=gen).to(torch.int32)
    mask = 0x2FFFFFFF if nw == 8 else 0x0FFFFFFF
    while q is not None and mask >= q >> (32 * (nw - 1)):
        mask >>= 1
    w[:, nw - 1::nw] &= mask
    return w


# ---------------------------------------------------------------------------
# PLONK: K10-K13 on the card, the mimc_plonk / rc_plonk / plonk_20 cells
# ---------------------------------------------------------------------------

def lift_p(ff, w, rows):
    """w with p added to the given rows (each < p), on the card: inputs
    in [p, 2p) made without host ints."""
    import torch
    x = w[rows].to(torch.int64) & 0xFFFFFFFF
    p = torch.tensor([(ff.p.modulus >> (32 * i)) & 0xFFFFFFFF
                      for i in range(ff.nw)], device=w.device)
    carry = torch.zeros_like(x[:, 0])
    for i in range(ff.nw):
        s = x[:, i] + p[i] + carry
        x[:, i], carry = s & 0xFFFFFFFF, s >> 32
    w = w.clone()
    w[rows] = x.to(torch.int32)
    return w


def dev_rows(ff, n, gen, zeros=()):
    """n random canonical rows made on the card, every third one lifted
    into [p, 2p), the given rows zero (0 and p in turn)."""
    import torch
    w = lift_p(ff, rand_dev_words(n, ff.nw, gen, ff.nw, ff.p.modulus),
               torch.arange(1, n, 3, device=DEV))
    z = torch.as_tensor(list(zeros), dtype=torch.int64, device=DEV)
    w[z] = 0
    w[z[::2]] = raw_words([ff.p.modulus])
    return w


def scan_plain(ff, a, chunk=1 << 22):
    """scan_mul_plain over pieces of `chunk` rows, each piece times the
    prefix before it by the plain product: the same function in pieces
    (the plain product holds 256 float64 a row, so 2^24 rows at once
    would need 32 GB a temporary)."""
    import torch
    from gnark_tpu_torch.ff import ops
    from gnark_tpu_torch.ff.mont_mul import mont_mul_plain
    out, carry = [], None
    for s in range(0, a.shape[0], chunk):
        y = ops.scan_mul_plain(ff, a[s:s + chunk])
        if carry is not None:
            y = mont_mul_plain(ff, y, carry)
        carry = y[-1:]
        out.append(y)
    return torch.cat(out)


def cuda_kernels(fn):
    """The names of the CUDA kernels one call of fn starts on the card,
    by the profiler's device trace ([] if it saw no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name.split("(")[0].split()[-1] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# the CUDA kernels one call of each starts at 2^20 rows
FF_OPS_KERNELS = {"ff_addsub": ("addsub_kernel",),
                  "batch_inv": ("inv_up_kernel", "inv_mid_kernel",
                                "inv_down_kernel"),
                  "scan_mul": ("scan_kernel",),
                  "dot": ("dot_kernel",),
                  "dot_many": ("dot_kernel",),
                  "plonk_numerator": ("numerator_kernel",)}


def num_case(ff, n, period, gen, rng):
    """K14's inputs at n rows, made on the card: the 13 columns (a third
    of each in [p, 2p), dev_rows), points x = c w (w such rows too, c a
    random int), a Z_H table of `period` random entries and their
    inverses, random challenges. Returns (cols, points, challenges)."""
    from gnark_tpu_torch.backend.plonk_num import NUM_COLS, NumPoints
    q = ff.p.modulus
    cols = {k: dev_rows(ff, n, gen) for k in NUM_COLS}
    zh = tuple(rng.randrange(1, q) for _ in range(period))
    pts = NumPoints(dev_rows(ff, n, gen), rng.randrange(1, q), zh,
                    tuple(pow(v, -1, q) for v in zh),
                    ("smoke", n, period, rng.random()))
    s = {k: rng.randrange(q) for k in ("beta", "gamma", "alpha", "u")}
    s.update(alpha2=s["alpha"] ** 2 % q, u2=s["u"] ** 2 % q,
             Ninv=rng.randrange(1, q))
    return cols, pts, s


def num_plain(ff, cols, pts, s, kernels=False):
    """numerator_plain at K14's points: its plain version (kernels
    False), or the K1 / K10 / K11 sequence K14 replaced, the points'
    x product included."""
    from gnark_tpu_torch.backend.plonk_num import numerator_plain
    return numerator_plain(ff, cols, pts.x(ff), pts.table(ff, pts.zh),
                           pts.table(ff, pts.zhi), s, kernels=kernels)


def phase_kernels_ff_ops(rng, res, cv="bn254"):
    """K10-K14 against their plain versions: one row, rows not a power of
    two, 2^16 and 2^20 rows, a third of each operand in [p, 2p) and a
    zero row in every 97 (0 and p); K11 on all zeros, a whole tile of
    zero rows, one nonzero row among zeros, at its least tile (2048 rows)
    - 1, + 0, + 1, at 256 and 257 such tiles (its one-block pass: 256
    threads) and at 2^21 (the openings: longer tiles); K12 without zeros
    at its tile (8192 rows) - 1, + 0, + 1, 2^20, 2^22 + 1 and 2^24 + 3
    rows (2,049 tiles: the look-back over thousands of tiles and many
    waves), and with one zero inside (every later prefix 0); K13 dot
    and dot_many at n = 1, 256, 257 (past one block) and 2^18 + 1 with 1,
    5 and 9 columns (9: two launches), each column a row shorter than the
    last; K14 at n = 1, 255, 256, 257 and 2^16 + 3 with one Z_H and a
    period-4 table, also against the K1 / K10 / K11 sequence it
    replaced. Then the CUDA kernels one call of each starts, by the
    profiler in a fresh process (kernel_counts). On BLS12-381's builds
    (the same sources in the sound class) the sizes past 2^20 that
    exercise the tiles' geometry (K11 at 256 tiles and 2^21, K12 at 2^22
    + 1 and 2^24 + 3, K13 at 2^18 + 1) are left to BN254's run; on a
    SHARED_FR curve (BN254's builds on its own constants) the sizes
    stop at 2^16 + 3 rows, and there is no trace (BN254's binaries,
    traced in BN254's phase 3)."""
    import torch
    from gnark_tpu_torch.backend.plonk_num import plonk_numerator
    from gnark_tpu_torch.ff import get_ff, ops
    fr = get_ff(f"{cv}_fr")
    q = fr.p.modulus
    err = {k: 0 for k in FF_OPS_KERNELS}

    def agree(name, got, want, shape):
        check(torch.equal(got, want), f"{name} {shape} disagrees with its "
              f"plain version")
        err[name] = max(err[name], max_abs(got, want))

    shared = cv in SHARED_FR
    for n in (1, 5, 2049, 1 << 16) + (() if shared else (1 << 20,)):
        a = rand_words(fr, n, rng, lazy=n // 3)
        b = rand_words(fr, n, rng, lazy=n // 3)
        if n > 1:                   # zeros: p (lazy) and 0
            a[::97] = raw_words([q])
            a[48::97] = 0
        for bb in (b, b[:1]):
            agree("ff_addsub", ops.add(fr, a, bb), ops.add_plain(fr, a, bb), n)
            agree("ff_addsub", ops.sub(fr, a, bb), ops.sub_plain(fr, a, bb), n)
        agree("batch_inv", ops.batch_inv(fr, a), ops.batch_inv_plain(fr, a),
              n)
        z = torch.zeros_like(a)
        agree("batch_inv", ops.batch_inv(fr, z), z, n)
        agree("scan_mul", ops.scan_mul(fr, a), ops.scan_mul_plain(fr, a), n)
        agree("dot", ops.dot(fr, a, b), ops.dot_plain(fr, a, b), n)
        agree("dot", ops.dot(fr, a), ops.dot_plain(fr, a), n)
    del a, b, z
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    T = ops.INV_TILE
    inv_cases = {"a tile of zeros": dev_rows(fr, 3 * T + 5, gen,
                                             range(T, 2 * T)),
                 "all zeros": dev_rows(fr, 2 * T + 3, gen, range(2 * T + 3)),
                 "one nonzero row": dev_rows(fr, 5000, gen, [
                     i for i in range(5000) if i != 3001])}
    full = cv == "bn254"
    for n in (T - 1, T, T + 1) + ((256 * T, 256 * T + 1, 1 << 21) if full
                                  else ()):
        inv_cases[n] = dev_rows(fr, n, gen, range(7, n, 997))
    for what, a in inv_cases.items():
        agree("batch_inv", ops.batch_inv(fr, a), ops.batch_inv_plain(fr, a),
              what)
    T = ops.SCAN_TILE
    scan_cases = {"a zero inside": dev_rows(fr, 5 * T + 7, gen,
                                            [3 * T + 100])}
    for n in (T - 1, T, T + 1) + (() if shared else (1 << 20,)) + \
            (((1 << 22) + 1, (1 << 24) + 3) if full else ()):
        scan_cases[n] = dev_rows(fr, n, gen)
    for what, a in scan_cases.items():
        agree("scan_mul", ops.scan_mul(fr, a), scan_plain(fr, a), what)
    del inv_cases, scan_cases, a
    for n in (1, 256, 257) + (((1 << 18) + 1,) if full else ()):
        pows = dev_rows(fr, n, gen)
        for k in (1, 5, 9):          # nine: two launches of up to eight
            cols = [dev_rows(fr, max(n - j, 1), gen) for j in range(k)]
            agree("dot_many", ops.dot_many(fr, cols, pows),
                  ops.dot_many_plain(fr, cols, pows), (n, k))
        agree("dot", ops.dot(fr, cols[0], pows), ops.dot_plain(
            fr, cols[0], pows), n)
        agree("dot", ops.dot(fr, pows), ops.dot_plain(fr, pows), n)
    del pows, cols
    for n in (1, 255, 256, 257, (1 << 16) + 3):
        for period in (1, 4):
            cols, pts, sc = num_case(fr, n, period, gen, rng)
            got = plonk_numerator(fr, cols, pts, sc)
            agree("plonk_numerator", got, num_plain(fr, cols, pts, sc),
                  (n, period))
            agree("plonk_numerator", got, num_plain(fr, cols, pts, sc, True),
                  (n, period, "the K1 / K10 / K11 sequence"))
    del cols, pts, got
    for k, v in err.items():
        res[k]["max_abs_err"] = v
    big = "" if shared else ", 2^20"
    log(f"K10 ff_addsub, K11 batch_inv, K12 scan_mul, K13 dot {cv}: n = 1, 5, "
        f"2049, 2^16{big} with lazy inputs (a first row at 2p - 1) and "
        f"zeros; K11 on a tile of zeros, all zeros, one nonzero row, n = "
        f"2047, 2048, 2049{', 2^19, 2^19 + 1, 2^21' if full else ''}; K12 "
        f"with a zero inside and at n = 8191, 8192, 8193{big}"
        f"{', 2^22 + 1, 2^24 + 3' if full else ''}; K13 dot and dot_many "
        f"(1, 5, 9 columns of unequal lengths) at n = 1, 256, 257"
        f"{', 2^18 + 1' if full else ''}; K14 at n = 1, 255, 256, 257, "
        f"2^16 + 3, period 1 and 4, also against the K1 / K10 / K11 "
        f"sequence: bit-exact against their plain versions")
    if shared:
        log(f"CUDA kernels a call of K10-K14 {cv}: not traced (BN254's "
            f"binaries, traced in BN254's phase 3)")
        return
    seen = kernel_counts(cv)
    if not any(seen.values()):
        log(f"CUDA kernels a call of K10-K14 {cv}: not measured (the "
            f"profiler saw no device activity)")
        return
    counts = {}
    for k, names in seen.items():
        ours = [m for m in names if m in FF_OPS_KERNELS[k]]
        counts[k] = len(ours)
        check(sorted(ours) == sorted(FF_OPS_KERNELS[k]),
              f"{k} {cv}: one call at 2^20 started {ours}, not "
              f"{FF_OPS_KERNELS[k]}")
    log(f"CUDA kernels one call starts at 2^20 {cv} (profiler): "
        + json.dumps(counts) + "; everything the profiler saw: "
        + json.dumps(seen))


TRACE_TRIES = 12


def kernel_counts(cv):
    """The CUDA kernels one call of each of K10-K14 starts at 2^20 rows
    of curve cv's scalar field, by the profiler's device trace, taken in
    a fresh process (this script with --kernel-counts cv; late in a long
    process the profiler can record nothing): {wrapper: [kernel
    names]}."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--kernel-counts", cv], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"--kernel-counts {cv} failed: "
          f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def traced_ff_ops(cv):
    """kernel_counts' process: one call of each of K10-K14 at 2^20 rows
    (their libraries are built already), each under the profiler."""
    import torch
    from gnark_tpu_torch.backend.plonk_num import plonk_numerator
    from gnark_tpu_torch.ff import get_ff, ops
    fr = get_ff(f"{cv}_fr")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    a = dev_rows(fr, 1 << 20, gen)
    cols, pts, sc = num_case(fr, 1 << 20, 1, gen, random.Random(5))
    pts.zdiv(fr)                   # its points' kept column, made once
    calls = {"ff_addsub": lambda: ops.add(fr, a, a),
             "batch_inv": lambda: ops.batch_inv(fr, a),
             "scan_mul": lambda: ops.scan_mul(fr, a),
             "dot": lambda: ops.dot(fr, a, a),
             "dot_many": lambda: ops.dot_many(fr, [a] * 5, a),
             "plonk_numerator": lambda: plonk_numerator(fr, cols, pts, sc)}
    for fn in calls.values():      # loads the libraries outside the trace
        fn()
    # the profiler's first sessions in a process can miss the kernels
    # they should see (three in a row in one run, with two other
    # processes on the card; the smoke runs up to four beside it): sessions are
    # thrown away until one sees its call's kernels, at most TRACE_TRIES
    for _ in range(TRACE_TRIES):
        if cuda_kernels(calls["ff_addsub"]):
            break
    wrappers = {w.__name__: w for w in all_wrappers()}
    seen = {}
    for k, fn in calls.items():
        for _ in range(TRACE_TRIES):
            n0 = wrappers[k].launches
            seen[k] = cuda_kernels(fn)
            # an empty trace of a call its wrapper says launched is the
            # profiler's miss, not the call's: it is taken again
            if seen[k] or wrappers[k].launches == n0:
                break
    return seen


def tampered_plonk(proof, curve):
    """A tampered claimed value and a tampered commitment (Z + G)."""
    import dataclasses
    from gnark_tpu_torch.ec import host
    q = curve.fr.modulus
    return {"claimed value": dataclasses.replace(
                proof, claimed=[(proof.claimed[0] + 1) % q]
                + list(proof.claimed[1:])),
            "commitment": dataclasses.replace(
                proof, z=host.ec_add(curve.host_fp, proof.z, curve.g1))}


def phase_plonk_small(res, cv="bn254"):
    """mimc_plonk (examples/mimc_plonk.py's circuit, SRS 2048) and
    rc_plonk (PLONK_RC_VALUES values through std/rangecheck: one BSB22
    commitment), or on a curve beyond BN254 cubic_381_plonk /
    cubic_377_plonk (examples/cubic.py's): the SRS and setup on the card,
    a prove on the card (the cubic: and the same prove on the CPU, the
    keys copied over, with equal bytes), verify, and a wrong public value
    or a tampered pi2 commitment (rc_plonk) refused."""
    import dataclasses
    from gnark_tpu_torch.backend import kzg, plonk
    from gnark_tpu_torch.backend.groth16_check import (
        Cubic, MimcPreimage, RangeChecked, range_checked_assignment)
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.frontend import compile_circuit, witness
    from gnark_tpu_torch.frontend.scs import SCSBuilder
    from gnark_tpu_torch.std.hash.mimc import mimc_hash
    pre = 0xDEADBEEF
    cases = (("mimc_plonk", MimcPreimage(),
              MimcPreimage(pre=pre, h=mimc_hash([pre])), 2048),
             ("rc_plonk", RangeChecked(PLONK_RC_VALUES),
              range_checked_assignment(PLONK_RC_VALUES, 5), None)) \
        if cv == "bn254" else \
        ((cell_name("cubic", cv), Cubic(), Cubic(x=3, y=35), 64),)
    # the card's proof against the CPU's: the other curves' cubic (the
    # BN254 cells' CPU halves, 36-68 s, are tests/test_torch_cuda.py's
    # test_plonk_card_equals_cpu)
    cpu_half = cv != "bn254"
    for what, circ, assign, srs_n in cases:
        t = time.perf_counter()
        cs = compile_circuit(circ, curves.CURVES[cv].fr,
                             builder_cls=SCSBuilder)
        pub, sec = witness(assign, cs)
        N = 1 << (cs.nb_public + cs.nb_constraints - 1).bit_length()
        srs = kzg.setup_srs(cv, srs_n or N + 8, rng=random.Random(0),
                            device=DEV)
        pk, vk = plonk.setup(cs, srs)
        sync()
        log(f"{what}: circuit {cs.summary()}, {len(cs.commitments)} "
            f"commitment(s), N = {vk.size}; SRS and setup on the card in "
            f"{time.perf_counter() - t:.2f} s")
        tm = {}
        wrappers = all_wrappers()
        for wr in wrappers:
            wr.launches = 0
        t = time.perf_counter()
        proof = plonk.prove(cs, pk, pub, sec, rng=random.Random(1),
                            timings=tm, device=DEV)
        tm["total"] = time.perf_counter() - t
        launches = {wr.__name__: wr.launches for wr in wrappers}
        log(f"{what} prove on the card (s): {fmt_times(tm)}; launches "
            + json.dumps(launches))
        if cpu_half:    # K5 takes this small domain's transforms
            check(launches["radix2_ntt"] > 0,
                  f"{what}: radix2_ntt was not launched")
            res["radix2_ntt"]["launches"] = launches["radix2_ntt"]
            t = time.perf_counter()
            # the plain MSM epilogue walks every bucket: c = 4 halves the
            # CPU's time at these sizes, and the MSM's value does not
            # depend on c
            with setenv("GNARK_TPU_MSM_C", "4"):
                cpu = plonk.prove(cs, pk.to("cpu"), pub, sec,
                                  rng=random.Random(1), device="cpu")
            check(dataclasses.asdict(cpu) == dataclasses.asdict(proof),
                  f"{what}: the card's proof differs from the CPU's")
            log(f"{what}: the CPU's prove (plain versions, "
                f"{time.perf_counter() - t:.1f} s) gives the card's proof "
                f"byte for byte")
        check(plonk.verify(proof, vk, pub), f"{what}: verify rejected")
        if pub:
            check(not plonk.verify(proof, vk, [(pub[0] + 1) % vk.curve.fr
                                               .modulus]),
                  f"{what}: verify accepted a wrong public value")
            log(f"{what} verify: True; with a wrong public value: False")
        else:
            bad = dataclasses.replace(proof, bsb22=[proof.lro[0]])
            check(not plonk.verify(bad, vk, pub),
                  f"{what}: verify accepted a tampered pi2 commitment")
            log(f"{what} verify: True; with a tampered pi2 commitment: "
                f"False")


def plonk_refused(cv):
    """On a GROTH16_ONLY curve: PLONK on the card raises before any work.
    plonk.setup on an SRS made on the card (a ladder and an affine_words
    launch) refuses, naming K11's inverse, with no launch of any other
    kernel, and PLONK's field kernels refuse to bind for the 12-word
    scalar field (no nvcc is started for them)."""
    from gnark_tpu_torch import cuda
    from gnark_tpu_torch.backend import kzg, plonk
    from gnark_tpu_torch.backend.groth16_check import Cubic
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.frontend import compile_circuit
    from gnark_tpu_torch.frontend.scs import SCSBuilder
    c = curves.CURVES[cv]
    cs = compile_circuit(Cubic(), c.fr, builder_cls=SCSBuilder)
    srs = kzg.setup_srs(cv, 16, rng=random.Random(43), device=DEV)
    wrappers = all_wrappers()
    for wr in wrappers:
        wr.launches = 0
    try:
        plonk.setup(cs, srs)
        raise Fail(f"plonk over {cv}: setup on the card did not raise")
    except ValueError as e:
        check("by_inv" in str(e), f"plonk over {cv}: raised {e!r}")
    launched = {wr.__name__: wr.launches for wr in wrappers if wr.launches}
    check(not launched, f"plonk over {cv}: launched {launched} first")
    for src in ("ff_ops", "plonk_num"):
        try:
            cuda.lib(src, c.fr.name)
            raise Fail(f"{src} bound for {c.fr.name}")
        except ValueError:
            pass
    log(f"plonk over {cv} on the card: setup raised before any launch "
        f"(K11's inverse takes 8-word fields); ff_ops and plonk_num refuse "
        f"to bind for {c.fr.name}")


def phase_plonk20(res, cv="bn254"):
    """plonk_20: BN254 PLONK on 2^20 - 1 squaring-chain gates, N = 2^20
    (the rho path; plonk_381_18, plonk_377_18 over the other curves, N =
    2^cell_log): an SRS of N + 8 (one ladder and one affine_words
    launch), setup, three proves with every launch count set to 0 first
    (K10-K14, K1, K2 and the bucket MSM must launch; K3 and K5 must
    not; each steady prove: K14 once a shift, K11 3, K12 8, K13 three
    calls of one kernel, K1 at most 135 and K10 at most 54 times),
    verify, and a tampered claimed value and a tampered commitment
    refused."""
    from gnark_tpu_torch.backend import kzg, plonk
    from gnark_tpu_torch.backend.groth16_check import plonk_square_chain
    from gnark_tpu_torch.backend.plonk_device import RHO_MIN_LOG
    from gnark_tpu_torch.ec import curves
    from gnark_tpu_torch.msm.fixed_base import affine_words, batch_scalar_mul
    what, lg = cell_name("plonk", cv), cell_log("plonk", cv)
    chains = PLONK_CHAINS >> (20 - lg)
    t = time.perf_counter()
    cs = plonk_square_chain(chains, PLONK_LEN, curves.CURVES[cv].fr)
    log(f"{what}: circuit {cs.summary()} built in "
        f"{time.perf_counter() - t:.2f} s")
    for wr in (batch_scalar_mul, affine_words):
        wr.launches = 0
    tm = {}
    t = time.perf_counter()
    srs = kzg.setup_srs(cv, chains * PLONK_LEN + 8,
                        rng=random.Random(3), device=DEV, timings=tm)
    tm["total"] = time.perf_counter() - t
    log(f"{what} SRS of 2^{lg} + 8 (s): {fmt_times(tm)}")
    check(batch_scalar_mul.launches == 1 and affine_words.launches == 1,
          f"{what} SRS: not one ladder and one affine_words launch")
    tm = {}
    t = time.perf_counter()
    pk, vk = plonk.setup(cs, srs, timings=tm)
    tm["total"] = time.perf_counter() - t
    log(f"{what} setup (s): {fmt_times(tm)}")
    check(vk.size == 1 << lg, f"{what}: N = {vk.size}, not 2^{lg}")
    check(vk.size >= 1 << RHO_MIN_LOG,
          f"{what} would not take the rho path")

    wrappers = all_wrappers()
    for wr in wrappers:
        wr.launches = 0
    sec = [i + 2 for i in range(chains)]
    proofs = []
    # a steady prove's calls: exactly, or at most (K1, K10)
    want = {"plonk_numerator": 4, "batch_inv": 3, "scan_mul": 8,
            "dot_many": 1, "dot": 2}
    most = {"mont_mul": 135, "ff_addsub": 54}
    for i in range(3):
        tm = {}
        was = {wr.__name__: wr.launches for wr in wrappers}
        t = time.perf_counter()
        proofs.append(plonk.prove(cs, pk, [], sec, rng=random.Random(4 + i),
                                  timings=tm, device=DEV))
        tm["total"] = time.perf_counter() - t
        calls = {k: ({wr.__name__: wr.launches for wr in wrappers}[k]
                     - was[k]) for k in list(want) + list(most)}
        log(f"{what} prove {i} (s): {fmt_times(tm)}; calls: "
            + json.dumps(calls))
        if i:       # the steady proves (the first also builds the domains
            #         and the shifts' kept Z_H(x) / (x - 1) columns)
            for k, v in want.items():
                check(calls[k] == v, f"{what} prove {i}: {k} called "
                      f"{calls[k]} times, not {v}")
            for k, v in most.items():
                check(calls[k] <= v, f"{what} prove {i}: {k} called "
                      f"{calls[k]} times, more than {v}")
    launches = {wr.__name__: wr.launches for wr in wrappers}
    log(f"launches during 3 {what} proves: " + json.dumps(launches))
    for k in ("ff_addsub", "batch_inv", "scan_mul", "dot", "dot_many",
              "plonk_numerator", "mont_mul", "fourstep_ntt", "bucket_digits",
              "bucket_msm", "bucket_reduce"):
        check(launches[k] > 0, f"{what}: {k} was not launched")
    for k in ("proj_add", "proj_double", "radix2_ntt", "row_fft"):
        check(launches[k] == 0, f"{what}: {k} was launched "
              f"{launches[k]} times")
    for k in FF_OPS_KERNELS:
        res[k]["launches"] = launches[k]
    proof = proofs[1]
    t = time.perf_counter()
    check(plonk.verify(proof, vk, []), f"{what}: verify rejected a proof")
    log(f"{what} verify: True in {time.perf_counter() - t:.3f} s")
    for tag, bad in tampered_plonk(proof, vk.curve).items():
        check(not plonk.verify(bad, vk, []),
              f"{what}: verify accepted a tampered {tag}")
    log(f"{what} verify with a tampered claimed value: False; with a "
        f"tampered commitment: False")
    return launches


def times_ff_ops(res, put, rng, n=1 << 20, cv="bn254", two_n=True,
                 numerator=True):
    """K10-K13 and, if numerator, K14 (times_numerator) at plonk_20's
    shapes (N = 2^20; K11 also at the openings' 2N if two_n), each
    against its plain version on the same inputs. Bounds: K10
    the bytes (two reads and a write, or one read and a write with the
    broadcast operand); K11 three products an element (the trick's least
    work; its one inversion a call, ~600 divsteps, not counted); K12 the
    larger of its 64 B an element and n - 1 products (a sequential
    scan's work; the kernel does two products an element, 2n products'
    time logged beside); K13 a sop2 (two products, one reduction) for
    two elements of a column (its adds not counted), against its bytes
    (each column and the powers read once); K14 its 4,864 multiplies a
    row against its 15 reads and a write of 32 B. Times are CUDA-event
    times of the wrapper's call, its host work before the launch
    included (ff_ops_times.py gives device time by kernel, beside the
    parent tree's)."""
    import torch
    from gnark_tpu_torch.ff import get_ff, ops
    fr = get_ff(f"{cv}_fr")
    mul = MUL_OPS["mul"]
    a, b = rand_words(fr, n, rng), rand_words(fr, n, rng)
    for sfx, bb, nb in (("", b, 3 * n * 32), ("_bcast", b[:1], 2 * n * 32)):
        ms, got = timed(lambda: ops.add(fr, a, bb))
        pms, want = timed(lambda: ops.add_plain(fr, a, bb), 3)
        put("ff_addsub", sfx, [n, 8], ms, pms, nb, 0, max_abs(got, want))
    ms, got = timed(lambda: ops.dot(fr, a, b))
    pms, want = timed(lambda: ops.dot_plain(fr, a, b), 1)
    put("dot", "", [n, 8], ms, pms, 2 * n * 32 + 32,
        n * MUL_OPS["sop2"] // 2, max_abs(got, want))
    # the evaluations' batch: five columns (l, r, o, s1, s2 of plonk_20:
    # N + 2 rows and N; here n) against one powers vector
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    cols = [dev_rows(fr, n - (j % 2) * 2, gen) for j in range(5)]
    ms, got = timed(lambda: ops.dot_many(fr, cols, b))
    pms, want = timed(lambda: ops.dot_many_plain(fr, cols, b), 1)
    rows = sum(c.shape[0] for c in cols)
    put("dot_many", "", [5, n, 8], ms, pms, (rows + n + 5) * 32,
        rows * MUL_OPS["sop2"] // 2, max_abs(got, want))
    ms5, got5 = timed(lambda: torch.cat([ops.dot(fr, c, b[:c.shape[0]])
                                         for c in cols]))
    check(torch.equal(got5, got), "dot_many: five dot calls disagree")
    res["dot_many"]["five_dot_ms"] = ms5
    log(f"dot_many {cv} [5, {n}, 8]: {ms:.4f} ms; five dot calls "
        f"{ms5:.4f} ms")
    del cols, got5
    if numerator:
        times_numerator(res, put, rng, n, cv, gen)
    ms, got = timed(lambda: ops.scan_mul(fr, a))
    pms, want = timed(lambda: ops.scan_mul_plain(fr, a), 1)
    put("scan_mul", "", [n, 8], ms, pms, 2 * n * 32, (n - 1) * mul,
        max_abs(got, want))
    log(f"scan_mul {[n, 8]}: two products an element (the kernel's work) "
        f"{bound_ms(0, 2 * n * mul, put.rate)[0]:.4f} ms at the card's "
        f"product rate")
    for sfx, m in (("", n), ("_2n", 2 * n))[:2 if two_n else 1]:
        x = rand_words(fr, m, rng) if m != n else a
        ms, got = timed(lambda: ops.batch_inv(fr, x))
        pms, want = timed(lambda: ops.batch_inv_plain(fr, x), 1,
                          warm=False)
        put("batch_inv", sfx, [m, 8], ms, pms, 2 * m * 32, 3 * m * mul,
            max_abs(got, want))
    del a, b, x, got, want


def times_numerator(res, put, rng, n=1 << 20, cv="bn254", gen=None):
    """K14 at plonk_20's shape (one shift) against its plain version and
    against the K1 / K10 / K11 sequence it replaced, on the same
    inputs."""
    import torch
    from gnark_tpu_torch.backend.plonk_num import plonk_numerator
    from gnark_tpu_torch.ff import get_ff
    fr = get_ff(f"{cv}_fr")
    if gen is None:
        gen = torch.Generator(device=DEV)
        gen.manual_seed(5)
    cols, pts, sc = num_case(fr, n, 1, gen, rng)
    ms, got = timed(lambda: plonk_numerator(fr, cols, pts, sc))
    pms, want = timed(lambda: num_plain(fr, cols, pts, sc), 1, False)
    put("plonk_numerator", "", [n, 8], ms, pms, 16 * n * 32,
        n * MUL_OPS["numerator"], max_abs(got, want))
    sms, seq = timed(lambda: num_plain(fr, cols, pts, sc, True))
    check(torch.equal(seq, got), "plonk_numerator: the K1 / K10 / K11 "
          "sequence disagrees")
    res["plonk_numerator"]["sequence_ms"] = sms
    log(f"plonk_numerator {cv} [{n}, 8]: {ms:.4f} ms; the K1 / K10 / K11 "
        f"sequence it replaced (45 launches) {sms:.4f} ms; the bytes "
        f"alone {bound_ms(16 * n * 32, 0, put.rate)[0]:.4f} ms")


# ---------------------------------------------------------------------------

KERNELS = {
    "mont_mul": ("gnark_tpu_torch/csrc/mont_mul.cu",
                 "gnark_tpu/ff/pallas_ops.py:34 mul_p; "
                 "gnark_tpu/ntt/fourstep.py:198 _mid_mul"),
    "row_fft": ("gnark_tpu_torch/csrc/row_fft.cu",
                "gnark_tpu/ntt/fourstep.py:114 _row_fft (rows alone, off "
                "the main path: its transforms are fourstep_ntt's)"),
    "fourstep_ntt": ("gnark_tpu_torch/csrc/row_fft.cu",
                     "gnark_tpu/ntt/fourstep.py:114 _row_fft and :198 "
                     "_mid_mul with FourStep.__call__'s XLA transposes "
                     "(:175) and gnark_tpu/ntt/domain.py:164, :180 "
                     "_scale's coset and n^-1 products (ff/pallas_ops.py:34 "
                     "mul_p)"),
    "proj_add": ("gnark_tpu_torch/csrc/proj_ec.cu",
                 "gnark_tpu/ec/pallas_ec.py:316 proj_add_p"),
    "proj_double": ("gnark_tpu_torch/csrc/proj_ec.cu",
                    "gnark_tpu/ec/pallas_ec.py:346 proj_double_p"),
    "bucket_msm": ("gnark_tpu_torch/csrc/bucket_msm.cu",
                   "gnark_tpu/msm/bucket_kernel.py:304 _msm_device "
                   "(_accumulate_kernel:200)"),
    "radix2_ntt": ("gnark_tpu_torch/csrc/butterfly.cu",
                   "gnark_tpu/ff/pallas_ops.py:66 butterfly_p, now a whole "
                   "gnark_tpu/ntt/domain.py:53 _ntt_kernel"),
    "jac_add_mixed": ("gnark_tpu_torch/csrc/jac_ec.cu",
                      "gnark_tpu/ec/pallas_ec.py:288 jac_add_mixed_p"),
    "jac_double": ("gnark_tpu_torch/csrc/jac_ec.cu",
                   "gnark_tpu/ec/pallas_ec.py:370 jac_double_p"),
    "jac_add": ("gnark_tpu_torch/csrc/jac_ec.cu",
                "gnark_tpu/ec/pallas_ec.py:264 jac_add_p"),
    "jac_fold": ("gnark_tpu_torch/csrc/jac_ec.cu",
                 "gnark_tpu/ec/pallas_ec.py:264 jac_add_p as "
                 "gnark_tpu/msm/pippenger.py:187-189 folds the groups "
                 "(a suffix scan over G)"),
    "bucket_reduce": ("gnark_tpu_torch/csrc/bucket_reduce.cu",
                      "gnark_tpu/ec/pallas_ec.py:316 proj_add_p and :346 "
                      "proj_double_p as gnark_tpu/msm/bucket_kernel.py:"
                      "372-404 (_msm_device's epilogue) calls them"),
    "bucket_digits": ("gnark_tpu_torch/csrc/bucket_msm.cu",
                      "gnark_tpu/msm/bucket_kernel.py:100 signed_digits "
                      "(XLA, no Pallas kernel), in _msm_bucket_jit:300"),
    "batch_scalar_mul": ("gnark_tpu_torch/csrc/ladder.cu",
                         "gnark_tpu/ec/pallas_ec.py:370 jac_double_p and "
                         ":288 jac_add_mixed_p, fused as "
                         "gnark_tpu/msm/fixed_base.py:27-52 "
                         "batch_scalar_mul's fori_loop runs their formulas "
                         "(XLA, no Pallas kernel)"),
    "mont_mul_sub_mul": ("gnark_tpu_torch/csrc/mont_mul.cu",
                         "gnark_tpu/ff/pallas_ops.py:34 mul_p and the XLA "
                         "ffr.sub at gnark_tpu/backend/groth16.py:437"),
    "affine_words": ("gnark_tpu_torch/csrc/mont_mul.cu",
                     "gnark_tpu/ec/weierstrass.py:164 jac_to_affine (XLA "
                     "f.inv) over gnark_tpu/ff/pallas_ops.py:34 mul_p's "
                     "product"),
    "ff_addsub": ("gnark_tpu_torch/csrc/ff_ops.cu",
                  "none: gnark_tpu/ff/mont.py:201 FF.add and :206 FF.sub "
                  "(XLA) over whole columns, e.g. "
                  "gnark_tpu/backend/plonk_device.py:327 _numerator_t"),
    "batch_inv": ("gnark_tpu_torch/csrc/ff_ops.cu",
                  "none: gnark_tpu/ff/mont.py:330 FF.batch_inv (XLA "
                  "associative scans and a Fermat inverse), in "
                  "gnark_tpu/backend/plonk_device.py:250 _s2_z, :327 "
                  "_numerator_t, :121 open_quotient_dev"),
    "scan_mul": ("gnark_tpu_torch/csrc/ff_ops.cu",
                 "none: jax.lax.associative_scan(ff.mul) (XLA) at "
                 "gnark_tpu/backend/plonk_device.py:63, :193, :265"),
    "dot": ("gnark_tpu_torch/csrc/ff_ops.cu",
            "none: gnark_tpu/backend/plonk_device.py:66 ff_sum over "
            "ff.mul (XLA), dev_poly_eval:80 and _s4_evals:365"),
    "dot_many": ("gnark_tpu_torch/csrc/ff_ops.cu",
                 "none: gnark_tpu/backend/plonk_device.py:66 ff_sum over "
                 "ff.mul (XLA), one a column in _s4_evals:377-380"),
    "plonk_numerator": ("gnark_tpu_torch/csrc/plonk_num.cu",
                        "none: gnark_tpu/backend/plonk_device.py:327 "
                        "_numerator_t (one XLA expression: FF.mul, add, "
                        "sub, batch_inv), from _rho_quotient:800 and "
                        "_s3_num_commit:300"),
}


def step(what, fn, *args):
    """fn(*args), its wall time and the run's so far logged."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"[time] {what}: {time.perf_counter() - t:.1f} s "
        f"({time.perf_counter() - T_START:.1f} s in all)")
    return out


def phase3(rng, cv, r):
    step(f"phase 3 {cv} K1-K4, K9", phase_kernels, rng, r, cv)
    step(f"phase 3 {cv} K5-K8", phase_kernels_jac_ntt, rng, r, cv)
    step(f"phase 3 {cv} ladder", phase_kernels_ladder, rng, r, cv)
    step(f"phase 3 {cv} affine", phase_kernels_affine, rng, r, cv)
    if cv not in GROTH16_ONLY:
        step(f"phase 3 {cv} K10-K14", phase_kernels_ff_ops, rng, r, cv)


def result_rows(cv="bn254"):
    """The kernels line's rows, one a kernel of KERNELS (named
    "name@cv" beyond BN254), before any phase has filled them."""
    sfx = "" if cv == "bn254" else f"@{cv}"
    built = KERNELS if cv not in GROTH16_ONLY else \
        {k: v for k, v in KERNELS.items() if k not in FF_OPS_KERNELS}
    return {k: {"name": k + sfx, "route": "cuda", "source": s,
                "replaces": r + ("" if cv == "bn254" else f" ({cv} build)"),
                "launches": 0, "max_abs_err": None, "ms": None,
                "plain_ms": None, "bound_ms": None, "bound_by": None,
                "library_ms": None}
            for k, (s, r) in built.items()}


def curve_checks(cv):
    """The checks process of BN254 or a curve of CURVES2 (--curve-checks
    cv): once its libraries are in place (the parent's nvcc jobs, each
    put in place as it ends), its phase 3 and, for a curve of CURVES2,
    its cubic cell or PLONK refusal, which time nothing the kernels line
    reports but the plain ladder. Prints its rows as the last line."""
    from gnark_tpu_torch import cuda
    from gnark_tpu_torch.msm.bucket import window_bits
    import torch
    torch.set_num_threads(2)        # the cubic's CPU prove beside the run
    global C_MAIN
    C_MAIN = window_bits(1 << 20, DEV)
    libs = [cuda._target(n, v)
            for n, v in cuda.builds([f"{cv}_fp", f"{cv}_fr"])]
    t = time.perf_counter()
    while not all(so.exists() for so in libs):
        check(time.perf_counter() - t < CHECKS_WAIT_S,
              f"{cv}'s libraries not built in {CHECKS_WAIT_S} s")
        time.sleep(0.5)
    log(f"{cv}'s libraries built, waited {time.perf_counter() - t:.1f} s")
    r = result_rows(cv)
    phase3(random.Random(CHECKS_SEED), cv, r)
    if cv in GROTH16_ONLY:
        step(f"plonk over {cv} refused", plonk_refused, cv)
    elif cv != "bn254":
        step(f"phase 5 {cell_name('cubic', cv)}", phase_plonk_small, r, cv)
    print(json.dumps(r), flush=True)


def start_checks(cv):
    """Start curve_checks(cv) in a process of its own; its output goes
    to a temporary file."""
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--curve-checks", cv], stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def join_checks(cv, job):
    """Wait for the checks process of cv, relay its log and return its
    rows; raise if it failed."""
    proc, out = job
    t = time.perf_counter()
    proc.wait()
    out.seek(0)
    lines = out.read().splitlines()
    out.close()
    for line in lines[:-1]:
        print(f"  [{cv} checks] {line}", flush=True)
    check(proc.returncode == 0, f"{cv}'s checks process failed: "
          + "\n".join(lines[-40:]))
    log(f"{cv}'s checks process (phase 3" +
        (" and the PLONK refusal" if cv in GROTH16_ONLY else
         "" if cv == "bn254" else f" and {cell_name('cubic', cv)}") +
        f") joined, waited {time.perf_counter() - t:.1f} s")
    return json.loads(lines[-1])


def background(fn, *args):
    """fn(*args) in a thread; returns a join that re-raises its error."""
    import threading
    err = []

    def run():
        try:
            fn(*args)
        except Exception as e:              # relayed by the join
            err.append(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if err:
            raise err[0]
    return join


def log_builds(built):
    """Each library's build seconds and ptxas's register / spill lines."""
    for k, (sec, out) in sorted(built.items(), key=lambda kv: kv[1][0]):
        log(f"build {k}: {sec:.1f} s")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Function properties")):
                log("  " + line.strip())


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
    if "--kernel-counts" in argv:
        cv = argv[argv.index("--kernel-counts") + 1]
        print(json.dumps(traced_ff_ops(cv)), flush=True)
        return 0
    if "--curve-checks" in argv:
        try:
            curve_checks(argv[argv.index("--curve-checks") + 1])
        except Fail as e:
            print(f"chip_smoke: FAILED: {e}", flush=True)
            return 1
        return 0
    later, checks = {}, {}
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
        # every build starts now, one nvcc each; the other curves' at a
        # lower priority, so that BN254's (wanted first) take the cores,
        # and each curve's are waited for only before its phases (a
        # library another curve shares is built once, by the first)
        def builds_of(cv):
            t = time.perf_counter()
            log_builds(cuda.finish_builds(later[cv]))
            log(f"{cv}'s builds waited for {time.perf_counter() - t:.1f} s")

        seen, pairs = cuda.builds(["bn254_fp", "bn254_fr"]), {}
        for cv in CURVES2:
            pairs[cv] = [b for b in cuda.builds([f"{cv}_fp", f"{cv}_fr"])
                         if b not in seen]
            seen += pairs[cv]
        # the longest builds (BW6-761's 24-word point sources) first
        for cv in sorted(CURVES2, key=lambda cv: cv not in GROTH16_ONLY):
            later[cv] = cuda.start_builds(pairs[cv], nice=10)
        first = cuda.start_builds(cuda.builds(["bn254_fp", "bn254_fr"]))
        # the other curves' libraries are put in place by a thread each
        # as each nvcc ends, BN254's by the finish below; every curve's
        # checks process starts now and waits for its libraries
        bg = {} if quick else {cv: background(builds_of, cv)
                               for cv in CURVES2}
        if not quick:
            checks = {cv: start_checks(cv) for cv in ("bn254",) + CURVES2}
        log_builds(cuda.finish_builds(first))
        t1 = time.perf_counter()
        native._lib()
        log(f"build native solver: {time.perf_counter() - t1:.1f} s; "
            f"BN254's builds {time.perf_counter() - t:.1f} s")

        res = result_rows()
        # the other curves' kernels, rows of their own
        resc = {cv: result_rows(cv) for cv in CURVES2}
        from gnark_tpu_torch.msm.bucket import window_bits
        global C_MAIN
        C_MAIN = window_bits(1 << 20, DEV)
        log(f"bucket MSM window width at 2^20 points: c = {C_MAIN}")
        rng = random.Random(2024)

        def kernels_line():
            rows = list(res.values())
            for cv in CURVES2:     # a SHARED_FR or GROTH16_ONLY curve:
                rows += [r for r in resc[cv].values()   # the rows it timed
                         if cv not in SHARED_FR + GROTH16_ONLY or
                         r["ms"] is not None]
            return json.dumps({"kernels": rows})

        if quick:
            phase3(rng, "bn254", res)
            for cv in CURVES2:
                builds_of(cv)
                phase3(rng, cv, resc[cv])
            # the transforms and K8 / the fold at their path's shapes (a
            # g16_20 wire MSM: 2^20 + 2049 points, the class of 2^20 + 1)
            put = make_put(res, int_mul_rate())
            times_fourstep(res, put, rng, 1 << 20)
            times_k8(put, (1 << 20) + 1)
            times_ff_ops(res, put, rng)
            for cv in SHARED_FR:
                times_shared_fr(resc[cv], rng, cv)
            print(kernels_line(), flush=True)
            print(smi, flush=True)
            return 0
        n_pts, cs, pk, proof = step("phase 4 g16_20", phase_main, res)
        del pk, proof
        ladder_sc, key_cols = step("phase 5 g16_20 setup", phase_setup, res,
                                   cs, rng)
        del cs
        step("phase 5 merkle_d12", phase_merkle, res)
        step("phase 5 rc_20", phase_rc20, res)
        step("phase 5 mimc_plonk, rc_plonk", phase_plonk_small, res)
        step("phase 5 plonk_20", phase_plonk20, res)

        def phases_3_5(cv):
            """Curve cv's checks process (its phase 3 and cubic cell)
            waited for, its g16 and plonk cells; returns phase 6's
            arguments from its g16 cell."""
            if cv in checks:            # its phase 3 and cubic cell
                resc[cv] = join_checks(cv, checks.pop(cv))
            if cv in bg:
                bg.pop(cv)()
            r = resc[cv]
            ladder_sc2, key_cols2, n_pts2 = step(
                f"phase 5 {cell_name('g16', cv)}", phase_g16_2, r, rng, cv)
            if cv not in GROTH16_ONLY:
                step(f"phase 5 {cell_name('plonk', cv)}", phase_plonk20, r,
                     cv)
            return r, rng, n_pts2, ladder_sc2, key_cols2, cv

        # BLS12-381's phase 5, BN254's phase 6, BLS12-381's; then each
        # further curve's phases 5 and 6
        args = phases_3_5(CURVES2[0])
        # BN254's phase 3 rows: its errors and plain ladder, beside the
        # launches phases 4 and 5 counted here
        for k, row in join_checks("bn254", checks.pop("bn254")).items():
            for f, v in row.items():
                if res[k].get(f) is None:
                    res[k][f] = v
        step("phase 6 bn254", phase_times, res, rng, n_pts, ladder_sc,
             key_cols)
        del ladder_sc, key_cols
        step(f"phase 6 {CURVES2[0]}", phase_times, *args)
        for cv in CURVES2[1:]:
            del args
            torch.cuda.empty_cache()
            args = phases_3_5(cv)
            step(f"phase 6 {cv}", phase_times, *args)
        del args
        torch.cuda.synchronize()
        log(f"chip_smoke: every phase passed, "
            f"{time.perf_counter() - T_START:.1f} s in all")
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for started in later.values():
            cuda.stop_builds(started)
        for proc, out in checks.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    print(kernels_line(), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
