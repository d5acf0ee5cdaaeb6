"""Two faults of the port, fixed, on the CPU:
  * K4's grouping holds an MSM's (window, point) pairs at int32 offsets
    (csrc/bucket_msm.cu), so msm/bucket.chunk_plan cuts an MSM into
    chunks of fewer than MAX_PAIRS pairs: 2^27 points at c = 13 (W = 20)
    are two chunks of 2^26; the plan is computed from the sizes alone,
    with no tensor. A chunked MSM on the card is held against the
    single-shot one in tests/test_torch_cuda.py.
  * the native solver's build writes a file of its own and renames it
    into place: two builds started at once into a fresh directory both
    load a whole library."""

import ctypes
import threading

import pytest

from gnark_tpu_torch import native
from gnark_tpu_torch.msm import bucket
from gnark_tpu_torch.msm.bucket import MAX_PAIRS, chunk_plan, digit_count

NBITS = 254


@pytest.mark.parametrize("n, sizes", [
    (1 << 27, [1 << 26] * 2),
    ((1 << 27) + 5, [(1 << 26) + 3, (1 << 26) + 2]),
    ((1 << 20) + 2049, [(1 << 20) + 2049]),     # a g16_20 key column
    (1 << 31, [1 << 26] * 32),
])
def test_chunk_plan_keeps_k4_offsets_in_int32(n, sizes, monkeypatch):
    monkeypatch.delenv("GNARK_TPU_MSM_C", raising=False)
    plan = chunk_plan(n, NBITS, "cuda")
    assert [end - off for off, end, _ in plan] == sizes
    assert plan[0][0] == 0 and plan[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    for off, end, c in plan:
        assert c == bucket.window_bits(end - off, "cuda")
        assert digit_count(NBITS, c) * (end - off) < MAX_PAIRS
    assert plan[0][2] == 13


def test_chunk_plan_widths_and_explicit_chunks(monkeypatch):
    monkeypatch.setenv("GNARK_TPU_MSM_C", "2")              # W = 128
    plan = chunk_plan(1 << 25, NBITS, "cuda")
    assert len(plan) == 4 and all(c == 2 for *_, c in plan)
    monkeypatch.delenv("GNARK_TPU_MSM_C")
    assert chunk_plan(1000, NBITS, "cuda", chunk=300) == [
        (0, 300, 8), (300, 600, 8), (600, 900, 8), (900, 1000, 8)]
    assert chunk_plan(0, NBITS, "cpu") == []


def test_native_build_is_atomic(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    start = threading.Barrier(2)
    out, errors = [None, None], []

    def build(i):
        start.wait()
        try:
            out[i] = native._build()
        except Exception as e:                   # reported below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert out[0] == out[1] and out[0].parent == tmp_path / "build"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [out[0].name]
    for so in out:
        assert ctypes.CDLL(str(so)).gnark_tpu_solve
