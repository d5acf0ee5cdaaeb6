"""Device selection, and the build and binding of the CUDA kernels.

Each source csrc/<name>.cu is compiled by nvcc, alone, into a shared
library with a plain C interface under gnark_tpu_torch/_build/ (named by
a hash of the sources and flags, so a stale build is never reused), and
loaded with ctypes. Nothing is built when a module is imported: the first
launch of a kernel builds its library, and `build_all` builds all of them
at once, one nvcc process per source, started together.

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

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("mont_mul", "row_fft", "proj_ec", "bucket_msm", "butterfly",
           "jac_ec", "bucket_reduce", "ladder", "ff_ops", "plonk_num")
HEADERS = ("mont.cuh", "proj.cuh", "jac.cuh", "fp2s.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Fields the kernels take: 254-bit moduli in 8 words, Fp2 with u^2 = -1.
KERNEL_FIELDS = ("bn254_fp", "bn254_fr")


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


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    so = _target(name)
    if so.exists():
        return so, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp)


def _finish(name: str, so, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all(names=SOURCES) -> dict:
    """Build every kernel library in parallel. Returns name ->
    (seconds, nvcc/ptxas log); a library already built reports 0 s."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    res, errors = {}, []
    for n, (so, job) in jobs.items():
        try:
            log = _finish(n, so, job)
        except RuntimeError as e:
            errors.append(str(e))
            continue
        res[n] = (time.perf_counter() - t0 if job else 0.0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return res


@functools.lru_cache(maxsize=None)
def lib(name: str) -> ctypes.CDLL:
    so, job = _start(name)
    _finish(name, so, job)
    return ctypes.CDLL(str(so))


def bind(name: str, fn: str, nptr: int, rest=()):
    """ctypes function `fn` of library `name`: nptr pointer arguments,
    then the ctypes types in `rest`, then the stream; returns int."""
    f = getattr(lib(name), fn)
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
    """Kernel constants of a field: p, 2p and R mod p in 8 words each,
    then -p^-1 mod 2^32 (the 32-bit REDC constant; FieldParams.n0inv is
    the 16-bit one), then R^3 mod p in 8 words (csrc/mont.cuh by_inv's
    return to Montgomery form): 33 words, FieldC's layout."""
    if name not in KERNEL_FIELDS:
        raise ValueError(f"no CUDA kernel for field {name}")
    from gnark_tpu_torch.fields import FIELDS
    par = FIELDS[name]
    p = par.modulus

    def words(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

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
