"""Three faults of the port, fixed, on the CPU:
  * K4's grouping holds an MSM's (window, point) pairs at int32 offsets
    (csrc/bucket_msm.cu), so msm/bucket.chunk_plan cuts an MSM into
    chunks of fewer than MAX_PAIRS pairs: 2^27 points at c = 13 (W = 20)
    are two chunks of 2^26; the plan is computed from the sizes alone,
    with no tensor. A chunked MSM on the card is held against the
    single-shot one in tests/test_torch_cuda.py.
  * the native solver's build writes a file of its own and renames it
    into place: two builds started at once into a fresh directory both
    load a whole library;
  * K2 held a whole row of 2^ceil(k/2) points in one block's shared
    memory, more than an H100 block may have from a 2^25 domain on (rows
    of 2^13, 256 KB): ntt/fourstep.row_plan runs every stage past
    2^SMEM_LOG in global register passes, so no block asks for more than
    the card gives; decided from the sizes alone, with the host's copy
    of the kernel's shared-memory formula (seg_smem_bytes; the card holds
    it to the kernel's own in tests/test_torch_cuda.py). The card runs a
    2^25 round trip in chip_smoke.py and the passes at a lowered cap in
    tests/test_torch_cuda.py."""

import ctypes
import threading

import pytest

from gnark_tpu_torch import native
from gnark_tpu_torch.msm import bucket
from gnark_tpu_torch.msm.bucket import MAX_PAIRS, chunk_plan, digit_count
from gnark_tpu_torch.ntt import fourstep
from gnark_tpu_torch.ntt.fourstep import (SMEM_LIMIT, fourstep_shape,
                                          row_plan, seg_smem_bytes)

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


@pytest.mark.parametrize("S, plan", [
    (1 << 10, ((), 10)),
    (1 << 12, ((), 12)),
    (1 << 13, ((1,), 12)),                    # a 2^25 or 2^26 domain's rows
    (1 << 14, ((2,), 12)),                    # 2^27, 2^28 (Fr's 2-adicity)
    (1 << 16, ((3, 1), 12)),
])
def test_row_plan_puts_long_rows_in_global_passes(S, plan):
    assert row_plan(S) == plan
    passes, G = plan
    assert sum(passes) + G == S.bit_length() - 1
    assert all(1 <= r <= fourstep.PASS_MAX for r in passes)


@pytest.mark.parametrize("k", range(2, 29))
def test_fourstep_blocks_fit_shared_memory(k):
    """Every domain up to BN254 Fr's two-adicity: no segment block over
    the cap, and none asks for more shared memory than one H100 block may
    have (2^25 asked 256 KB before)."""
    S, n1 = fourstep_shape(1 << k)
    assert S * n1 == 1 << k and n1 <= S
    for m in (S, n1):
        passes, G = row_plan(m)
        assert G <= fourstep.SMEM_LOG
        assert seg_smem_bytes(G) <= SMEM_LIMIT
    if k == 25:
        assert (S, n1) == (1 << 13, 1 << 12)
        assert row_plan(S) == ((1,), 12) and row_plan(n1) == ((), 12)
        assert S * 32 > SMEM_LIMIT                # what failed before


def test_row_plan_cap_is_a_module_constant(monkeypatch):
    monkeypatch.setattr(fourstep, "SMEM_LOG", 3)
    assert row_plan(1 << 10) == ((3, 3, 1), 3)
    assert row_plan(1 << 3) == ((), 3)
    assert row_plan(2) == ((), 1)
