"""Native (C++) witness solver bindings.

Builds the repository's native/solver.cpp on first use (g++ -O3
-shared; cached under gnark_tpu_torch/_build/, written under a name of
its own and renamed into place) and drives it via ctypes. Fields up to 383
bits are supported via templated 4x64 / 6x64 limb arithmetic —
BN254/BLS12-381/BLS12-377 fr use 4 limbs, BW6-761 fr (377 bits) uses
6; anything wider falls back to the Python solver transparently.

solve_native() mirrors gnark_tpu_torch.constraint.solve()'s contract.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from gnark_tpu_torch.constraint.hints import get_hint
from gnark_tpu_torch.constraint.solver import Solution, SolverError

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "solver.cpp"
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"
_KINDS = {"r1c": 0, "assert": 1, "hint": 2, "scs": 3, "log": 4}


def _build() -> pathlib.Path:
    """The solver library in _BUILD, compiled if it is not there: g++
    writes a file of its own (process and thread in the name), which is
    then renamed into place, so a concurrent builder never loads a half
    written library."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    _BUILD.mkdir(parents=True, exist_ok=True)
    so = _BUILD / f"solver-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True)
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(_build()))
    lib.gnark_tpu_solve.restype = ctypes.c_int
    return lib


_HINT_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32)


def _nlimbs(cs) -> int:
    return 4 if cs.field.bits <= 255 else 6


def _to_limbs(x: int, nl: int) -> list[int]:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(nl)]


def _from_limbs(arr, nl: int) -> int:
    v = 0
    for i in range(nl):
        v |= int(arr[i]) << (64 * i)
    return v


def _marshal(cs):
    """Pack a ConstraintSystem into flat numpy arrays (cached on cs)."""
    blob = getattr(cs, "_native_blob", None)
    if blob is not None:
        return blob
    q = cs.q
    consts: dict[int, int] = {}

    def cidx_of(v):
        v %= q
        if v not in consts:
            consts[v] = len(consts)
        return consts[v]

    terms = []       # (const_idx, wire)

    def put_linexp(e):
        s = len(terms)
        for coeff, wire in e:
            terms.append((cidx_of(coeff), wire))
        return s, len(terms)

    r1c_off = []
    for con in cs.r1cs:
        l0, l1 = put_linexp(con.l)
        r0, r1 = put_linexp(con.r)
        o0, o1 = put_linexp(con.o)
        r1c_off.append((l0, l1, r0, r1, o0, o1))

    scs_data = []
    for con in cs.sparse:
        scs_data.append((con.xa, con.xb, con.xo, cidx_of(con.qL),
                         cidx_of(con.qR), cidx_of(con.qO),
                         cidx_of(con.qM), cidx_of(con.qC),
                         con.commitment))

    outputs = []
    hint_in_off = []
    inst_rows = []
    hint_meta = {}   # instruction row -> (hint_name, n_in, n_out)
    for inst in cs.instructions:
        kind = _KINDS[inst.kind]
        o0 = o1 = h0 = h1 = 0
        if inst.kind == "hint":
            o0 = len(outputs)
            outputs.extend(inst.outputs)
            o1 = len(outputs)
            h0 = len(hint_in_off)
            for e in inst.inputs:
                hint_in_off.append(put_linexp(e))
            h1 = len(hint_in_off)
            hint_meta[len(inst_rows)] = (
                inst.hint_name, len(inst.inputs), len(inst.outputs))
        inst_rows.append((kind, inst.cidx, o0, o1, h0, h1))

    nl = _nlimbs(cs)
    consts_arr = np.zeros((max(len(consts), 1), nl), dtype=np.uint64)
    for v, i in consts.items():
        consts_arr[i] = _to_limbs(v, nl)
    cs._native_blob = dict(
        consts=consts_arr,
        terms=np.array(terms or [(0, 0)], dtype=np.uint32),
        r1c_off=np.array(r1c_off or [(0,) * 6], dtype=np.uint32),
        scs=np.array(scs_data or [(0,) * 9], dtype=np.uint32),
        inst=np.array(inst_rows or [(4, 0, 0, 0, 0, 0)], dtype=np.int64),
        outputs=np.array(outputs or [0], dtype=np.uint32),
        hint_in_off=np.array(hint_in_off or [(0, 0)],
                             dtype=np.uint32).reshape(-1, 2),
        hint_meta=hint_meta,
        levels_flat=np.array(
            [i for lvl in cs.levels for i in lvl] or [0], dtype=np.int64),
        level_off=np.cumsum(
            [0] + [len(l) for l in cs.levels]).astype(np.uint32),
        n_levels=len(cs.levels),
    )
    return cs._native_blob


def supports(cs) -> bool:
    return cs.field.bits <= 383


def solve_native(cs, public: list, secret: list,
                 hint_overrides: dict | None = None) -> Solution:
    """Native solve; same semantics as constraint.solve()."""
    if not supports(cs):
        from gnark_tpu_torch.constraint.solver import solve as py_solve
        return py_solve(cs, public, secret, hint_overrides=hint_overrides)
    lib = _lib()
    q = cs.q
    if len(public) != cs.nb_public - 1 or len(secret) != cs.nb_secret:
        raise SolverError("assignment size mismatch")

    m = _marshal(cs)
    nl = _nlimbs(cs)
    nw = cs.nb_wires
    values = np.zeros((nw, nl), dtype=np.uint64)
    solved = np.zeros(nw, dtype=np.uint8)
    packed = b"".join(
        (v % q).to_bytes(8 * nl, "little")
        for v in [1] + list(public) + list(secret))
    n_in = 1 + len(public) + len(secret)
    values[:n_in] = np.frombuffer(packed, dtype=np.uint64).reshape(-1, nl)
    solved[:n_in] = 1
    n_r1c = len(cs.r1cs)
    abc = np.zeros((3 * max(n_r1c, 1), nl), dtype=np.uint64)
    err = ctypes.create_string_buffer(256)
    overrides = hint_overrides or {}
    cb_error = []

    @_HINT_CB
    def hint_cb(inst_id, in_ptr, n_in, out_ptr, n_out):
        name, _, _ = m["hint_meta"][inst_id]
        fn = overrides.get(name) or get_hint(name)
        ins = [_from_limbs(in_ptr[nl * j: nl * j + nl], nl)
               for j in range(n_in)]
        try:
            outs = fn(q, ins)
        except Exception as e:  # propagate as solver error
            cb_error.append(str(e))
            return 1
        if len(outs) != n_out:
            cb_error.append(f"hint {name}: bad arity")
            return 1
        for j, v in enumerate(outs):
            limbs = _to_limbs(v % q, nl)
            for k in range(nl):
                out_ptr[nl * j + k] = limbs[k]
        return 0

    def u64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    def u32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

    p_arr = np.array(_to_limbs(q, nl), dtype=np.uint64)
    r2_arr = np.array(_to_limbs((1 << (128 * nl)) % q, nl),
                      dtype=np.uint64)
    n0inv = (-pow(q, -1, 1 << 64)) % (1 << 64)

    rc = lib.gnark_tpu_solve(
        ctypes.c_int64(nl),
        u64p(p_arr), u64p(r2_arr), ctypes.c_uint64(n0inv),
        u64p(m["consts"]), ctypes.c_int64(len(m["consts"])),
        u32p(m["terms"]), ctypes.c_int64(len(m["terms"])),
        u32p(m["r1c_off"]), ctypes.c_int64(n_r1c),
        u32p(m["scs"]), ctypes.c_int64(len(cs.sparse)),
        m["inst"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(m["inst"])),
        u32p(m["outputs"]), u32p(m["hint_in_off"]),
        m["levels_flat"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        u32p(m["level_off"]), ctypes.c_int64(m["n_levels"]),
        hint_cb, ctypes.c_int64(nw),
        u64p(values), solved.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        u64p(abc), err, ctypes.c_int64(256))
    if rc != 0:
        msg = cb_error[0] if cb_error else err.value.decode()
        raise SolverError(f"native solver: {msg}")

    def rows_to_ints(arr, start, count):
        b = arr[start:start + count].tobytes()
        w = 8 * nl
        return [int.from_bytes(b[w * i: w * i + w], "little")
                for i in range(count)]

    vals = rows_to_ints(values, 0, nw)
    sol = Solution(values=vals)
    # zero-copy u64 views for device encoders (FF.encode_u64): the
    # prover's bulk limb conversions skip Python ints entirely
    sol.values_u64 = values
    if cs.kind == "r1cs":
        sol.abc_u64 = abc.reshape(3, max(n_r1c, 1), nl)
    if cs.kind == "r1cs":
        sol.a = rows_to_ints(abc, 0, n_r1c)
        sol.b = rows_to_ints(abc, n_r1c, n_r1c)
        sol.c = rows_to_ints(abc, 2 * n_r1c, n_r1c)
    # run deferred log instructions on the host (native skips them)
    for inst in cs.instructions:
        if inst.kind == "log":
            fmt, args = cs.logs[inst.cidx]
            resolved = []
            for e in args:
                s = 0
                for coeff, wire in e:
                    s = (s + coeff * vals[wire]) % q
                resolved.append(s)
            print(fmt.format(*resolved))
    return sol
