"""Card times of K11 batch_inv (2^20 and 2^21 rows), K12 scan_mul, K13
(one dot, and the evaluations' five columns at once: dot_many where the
tree has it, else five dot calls) and the PLONK quotient's numerator
(K14 where the tree has it, else the K1 / K10 / K11 sequence of its
_numerator, x's product included), all at 2^20 rows, for one or more
trees of this repository, on one NVIDIA GPU.
Each tree runs in its own process, in the order given, so two versions
are compared inside one call on one card in turns:

    python3 ff_ops_times.py OLD_TREE . . OLD_TREE

(OLD_TREE e.g. a `git archive` of the parent commit unpacked into an
ignored directory). Each tree builds its own kernels into its own
gnark_tpu_torch/_build/. Every tree gets the same seeded random rows, in
[0, p) with p added to every third one (lazy inputs); a digest of each
output shows that the trees agree. Times: the median of 20 CUDA-event
timings of one wrapper call, after one untimed call; and each CUDA
kernel's device time a call, the mean over 10 calls of the profiler's
device trace (torch's own fill kernels included, so the host's share of
a call is the event time less their sum). Prints a JSON line a tree,
then the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

SHAPES = (("batch_inv", 1 << 20), ("batch_inv", 1 << 21),
          ("scan_mul", 1 << 20), ("dot", 1 << 20), ("dot5", 1 << 20),
          ("numerator", 1 << 20))
NUM_COLS = ("l", "r", "o", "z", "zs", "ql", "qr", "qm", "qo", "qk", "s1",
            "s2", "s3")


def rows(ff, n, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = torch.randint(0, 1 << 32, (n, ff.nw), dtype=torch.int64,
                      device="cuda", generator=g)
    w[:, -1] &= 0x2FFFFFFF                  # < p for both BN254 fields
    lift = torch.arange(1, n, 3, device="cuda")
    carry = torch.zeros_like(lift)
    for i in range(ff.nw):
        s = w[lift, i] + ((ff.p.modulus >> (32 * i)) & 0xFFFFFFFF) + carry
        w[lift, i], carry = s & 0xFFFFFFFF, s >> 32
    return w.to(torch.int32)


def kernel_ms(fn, calls):
    """Device milliseconds a call of fn by kernel name (the profiler's
    trace of `calls` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = e.name.split("(")[0].split()[-1][:40]
            ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return ms


def numerator_call(fr, n):
    """The rho path's numerator at one shift of an n-point domain on
    seeded columns and challenges, as the tree computes it."""
    from gnark_tpu_torch.backend import plonk_device as pd
    from gnark_tpu_torch.ntt import get_domain
    q = fr.p.modulus
    cols = {k: rows(fr, n, 100 + j) for j, k in enumerate(NUM_COLS)}
    s = {k: (7 + j) ** 40 % q for j, k in enumerate(
        ("beta", "gamma", "alpha", "u"))}
    s.update(alpha2=s["alpha"] ** 2 % q, u2=s["u"] ** 2 % q,
             Ninv=pow(n, -1, q))
    wpow = pd.dev_powers(fr, get_domain(fr, n, "cuda").omega, n, "cuda")
    shift = fr.p.generator * get_domain(fr, 4 * n, "cuda").omega % q
    if hasattr(pd, "_shift_points"):
        pts = pd._shift_points(fr, wpow, n, shift)
        return lambda a: pd._numerator(fr, cols, pts, s)
    zh = (pow(shift, n, q) - 1) % q
    return lambda a: pd._numerator(fr, cols, pd._mul_s(fr, wpow, shift), zh,
                                   pow(zh, -1, q), s)


def five_dots(fr, ops, n):
    """The evaluations' five columns (n and n - 2 rows) at once."""
    import torch
    cols = [rows(fr, n - (j % 2) * 2, 200 + j) for j in range(5)]
    if hasattr(ops, "dot_many"):
        return lambda a: ops.dot_many(fr, cols, a)
    return lambda a: torch.cat([ops.dot(fr, c, a[:c.shape[0]])
                                for c in cols])


def call_of(fr, ops, name, n):
    """The timed call of SHAPES' `name`, a function of the rows a."""
    if name == "dot":
        return lambda a: ops.dot(fr, a, a)
    if name == "dot5":
        return five_dots(fr, ops, n)
    if name == "numerator":
        return numerator_call(fr, n)
    return lambda a: getattr(ops, name)(fr, a)


def one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from gnark_tpu_torch.ff import get_ff, ops
    fr = get_ff("bn254_fr")
    out = {"tree": root}
    for name, n in SHAPES:
        fn = call_of(fr, ops, name, n)
        a = rows(fr, n, n)
        got = fn(a)
        times = []
        for _ in range(20):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(a)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        key = f"{name}_2^{n.bit_length() - 1}"
        out[key + "_ms"] = statistics.median(times)
        out[key + "_kernels_ms"] = kernel_ms(lambda: fn(a), 10)
        out[key + "_digest"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ff_ops_times: no CUDA device", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root]).returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
