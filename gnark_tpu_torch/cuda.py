"""Device selection, and the build and binding of the CUDA kernels.

Each source csrc/<name>.cu is compiled by nvcc, alone, into a shared
library with a plain C interface under gnark_tpu_torch/_build/ (named by
a hash of the sources and flags, so a stale build is never reused), and
loaded with ctypes. A source is built once for each variant its fields
need: the element's word count (GT_NW), the arithmetic class (GT_SOUND)
of csrc/mont.cuh and, for a base field, its Fp2's |u^2| (GT_NR_ABS; 0
for a base field with no Fp2, BW6-761's, whose build compiles no Fp2
code) and the words of the point kernels' scalars (GT_SW: 8, 12 on
BW6-761), each variant a library of its own name. Nothing is built when a
module is imported: the first launch of a kernel builds its library, and
`start_builds` / `finish_builds` build all of them at once, one nvcc
process per source and variant, started together.

Every C entry point takes data pointers and the current stream and
returns cudaGetLastError(); `check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("mont_mul", "row_fft", "proj_ec", "bucket_msm", "butterfly",
           "jac_ec", "bucket_reduce", "ladder", "ff_ops", "plonk_num")
HEADERS = ("mont.cuh", "proj.cuh", "jac.cuh", "fp2s.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelField(NamedTuple):
    """How the kernels take a field: nw 32-bit words an element; sound,
    the class of csrc/mont.cuh (lazy: values < 2p, which needs 4p < R =
    2^(32 nw); sound, for 4p >= R: every operation takes values < 2p and
    gives them < p); base, a curve's base field (the point kernels) or
    else a scalar field (the field kernels); nr, u^2 of the curve's Fp2
    (base fields; None: the curve has no Fp2, its G2 lies over Fp); sw,
    the words of the scalars the point kernels take (base fields)."""
    nw: int
    sound: bool
    base: bool
    nr: int | None = None
    sw: int = 8


# Fields the kernels take: BN254, BLS12-381, BLS12-377 (its Fp2 with u^2
# = -5; its scalar field on BN254's 8-word lazy builds) and BW6-761 (a
# 24-word Fp with no Fp2, 12-word scalars; its scalar field on BLS12-381's
# 12-word lazy mont_mul build).
KERNEL_FIELDS = {
    "bn254_fp": KernelField(nw=8, sound=False, base=True, nr=-1),
    "bn254_fr": KernelField(nw=8, sound=False, base=False),
    "bls12_381_fp": KernelField(nw=12, sound=False, base=True, nr=-1),
    "bls12_381_fr": KernelField(nw=8, sound=True, base=False),
    "bls12_377_fp": KernelField(nw=12, sound=False, base=True, nr=-5),
    "bls12_377_fr": KernelField(nw=8, sound=False, base=False),
    "bw6_761_fp": KernelField(nw=24, sound=False, base=True, sw=12),
    "bw6_761_fr": KernelField(nw=12, sound=False, base=False),
}
# The sources a base field's (points) and a scalar field's kernels need;
# a scalar field wider than 8 words builds Groth16's alone (K11's
# inverse, csrc/mont.cuh by_inv, takes 8 words only, and with it
# ff_ops and plonk_num: PLONK).
BASE_SOURCES = ("mont_mul", "proj_ec", "bucket_msm", "jac_ec",
                "bucket_reduce", "ladder")
SCALAR_SOURCES = ("mont_mul", "row_fft", "butterfly", "ff_ops", "plonk_num")
GROTH16_SCALAR_SOURCES = ("mont_mul", "row_fft", "butterfly")


class Variant(NamedTuple):
    """One build of a source: GT_NW, GT_SOUND, GT_NR_ABS (|u^2| of the
    Fp2 the point kernels take; 0: no Fp2 code; 1 for a scalar field's
    build) and GT_SW (the point kernels' scalar words; 8 for a scalar
    field's build)."""
    nw: int
    sound: bool
    nr_abs: int
    sw: int = 8

    @property
    def tag(self) -> str:
        return (f"w{self.nw}" + ("-sound" if self.sound else "")
                + (f"-sw{self.sw}" if self.sw != 8 else "")
                + ("-nofp2" if self.nr_abs == 0 else
                   f"-nr{self.nr_abs}" if self.nr_abs != 1 else ""))

    @property
    def flags(self) -> tuple:
        return (f"-DGT_NW={self.nw}", f"-DGT_SOUND={int(self.sound)}",
                f"-DGT_NR_ABS={self.nr_abs}", f"-DGT_SW={self.sw}")


def kernel_field(name: str) -> KernelField:
    kf = KERNEL_FIELDS.get(name)
    if kf is None:
        raise ValueError(f"no CUDA kernel for field {name} (the kernels "
                         f"take {', '.join(KERNEL_FIELDS)})")
    return kf


def variant(field: str) -> Variant:
    kf = kernel_field(field)
    if not kf.base:
        return Variant(kf.nw, kf.sound, 1)
    return Variant(kf.nw, kf.sound, 0 if kf.nr is None else -kf.nr, kf.sw)


def sources(field: str) -> tuple:
    """The sources field's kernels are built from."""
    kf = kernel_field(field)
    if kf.base:
        return BASE_SOURCES
    return SCALAR_SOURCES if kf.nw == 8 else GROTH16_SCALAR_SOURCES


def builds(fields=None) -> list:
    """(source, Variant) of every library the fields' kernels use, each
    once (BN254's two fields and BLS12-377's scalar field share one build
    of each source, BLS12-381's Fp and BW6-761's scalar field mont_mul's
    12-word one)."""
    out = []
    for f in (KERNEL_FIELDS if fields is None else fields):
        out += [(s, variant(f)) for s in sources(f)]
    return list(dict.fromkeys(out))


def resolve_device(device=None) -> torch.device:
    """None means the card. A CUDA device without CUDA raises; a CUDA
    device comes back with its index, so "cuda" and "cuda:0" name the
    same device (and the same cached Domain)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_curve(curve, device: torch.device, plonk: bool = False) -> None:
    """On the card, raise unless the kernels take both fields of curve
    (and its G2: over Fp2 with the build's u^2, or over Fp itself, the
    base field's own build) and, with plonk, the scalar field's PLONK
    kernels (K10-K14, 8 words only); no path falls back to the CPU."""
    if device.type != "cuda":
        return
    nr = kernel_field(curve.fp.name).nr
    kernel_field(curve.fr.name)
    if plonk and "ff_ops" not in sources(curve.fr.name):
        raise ValueError(
            f"no CUDA kernel for PLONK over {curve.name}: K11's inverse "
            f"(csrc/mont.cuh by_inv) takes 8-word fields only, not "
            f"{curve.name}'s {kernel_field(curve.fr.name).nw}-word Fr")
    if curve.g2 is None or not curve.g2_over_fp2:
        return
    if nr is None or (curve.fp2_nr - nr) % curve.fp.modulus:
        raise ValueError(f"no CUDA kernel for {curve.name}'s G2 (the "
                         f"kernels over {curve.fp.name} take "
                         + ("no Fp2" if nr is None else
                            f"Fp2 with u^2 = {nr}") + ")")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str, v: Variant) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + v.flags).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD / f"{name}.{v.tag}-{h.hexdigest()[:16]}.so"


def _start(name: str, v: Variant, nice: int = 0):
    so = _target(name, v)
    if so.exists():
        return so, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *v.flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    log = open(tmp.with_suffix(".log"), "w+")   # a pipe could fill and stall
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True,
                            preexec_fn=(lambda: os.nice(nice)) if nice
                            else None)
    return so, (proc, tmp, log)


def _finish(name: str, so, job) -> str:
    if job is None:
        return ""
    proc, tmp, log = job
    proc.wait()
    log.seek(0)
    out = log.read()
    log.close()
    os.remove(log.name)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    os.replace(tmp, so)
    return out


def start_builds(pairs=None, nice: int = 0) -> dict:
    """Start nvcc for every library of `builds()` (or the given (source,
    Variant) pairs) not built yet, all at once (nice: their priority,
    so that builds wanted first can be started beside them at a higher
    one). Returns the jobs for finish_builds."""
    return {"t0": time.time(),
            "jobs": {(n, v): _start(n, v, nice)
                     for n, v in (builds() if pairs is None else pairs)}}


def finish_builds(started: dict) -> dict:
    """Wait for started builds. Returns "source.tag" -> (seconds from
    their start to the end of nvcc's output, nvcc/ptxas log); a library
    already built reports 0 s. Raises if any build failed."""
    jobs, t0 = dict(started["jobs"]), started["t0"]
    res, errors = {}, []
    while jobs:
        done = [k for k, (so, job) in jobs.items()
                if job is None or job[0].poll() is not None]
        if not done:
            time.sleep(0.1)
        for n, v in done:
            so, job = jobs.pop((n, v))
            key = f"{n}.{v.tag}"
            try:
                sec = os.path.getmtime(job[2].name) - t0 if job else 0.0
                log = _finish(key, so, job)
            except (RuntimeError, OSError) as e:
                errors.append(str(e))
                continue
            res[key] = (sec, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return res


def stop_builds(started: dict) -> None:
    """End the started builds that are still running (a run that stops
    early leaves no nvcc behind)."""
    for so, job in started["jobs"].values():
        if job is not None and job[0].poll() is None:
            job[0].kill()
            job[0].wait()
        if job is not None and not job[2].closed:
            job[2].close()


@functools.lru_cache(maxsize=None)
def _lib(name: str, v: Variant) -> ctypes.CDLL:
    so, job = _start(name, v)
    _finish(f"{name}.{v.tag}", so, job)
    return ctypes.CDLL(str(so))


def lib(name: str, field: str) -> ctypes.CDLL:
    """Library `name` as built for `field`'s kernels; raises, before any
    build, for a field-kernel source the field is not built for (PLONK's
    ff_ops and plonk_num over a scalar field wider than 8 words)."""
    if name not in BASE_SOURCES + sources(field):
        raise ValueError(f"no {name} kernels for {field} (built: "
                         f"{', '.join(sources(field))})")
    return _lib(name, variant(field))


def bind(name: str, field: str, fn: str, nptr: int, rest=()):
    """ctypes function `fn` of library `name` built for `field`: nptr
    pointer arguments, then the ctypes types in `rest`, then the stream;
    returns int."""
    f = getattr(lib(name, field), fn)
    f.argtypes = [ctypes.c_void_p] * nptr + list(rest) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def field_consts(name: str) -> np.ndarray:
    """Kernel constants of a field: p, 2p and R mod p in nw words each,
    then -p^-1 mod 2^32 (the 32-bit REDC constant; FieldParams.n0inv is
    the 16-bit one), then R^3 mod p in nw words (csrc/mont.cuh by_inv's
    return to Montgomery form): 4 nw + 1 words, FieldC's layout."""
    nw = kernel_field(name).nw
    from gnark_tpu_torch.fields import FIELDS
    par = FIELDS[name]
    p = par.modulus
    if par.R != 1 << (32 * nw):
        raise ValueError(f"{name}: R is not 2^(32 * {nw})")

    def words(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]

    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return np.array(words(p) + words(2 * p) + words(par.R_mod) + [n0]
                    + words(par.R3_mod), dtype=np.uint32)


def dev_words(t: torch.Tensor, what: str, shape=None) -> torch.Tensor:
    """Validate an int32 word tensor for a kernel: CUDA, int32,
    contiguous and 16-byte aligned (copied if it is not), shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32 words, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t
