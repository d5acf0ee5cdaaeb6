"""Kernel K5 on the CPU: its one-stage helper butterfly's plain version
against the stage written out with host ints (inputs in [p, 2p)
included) and against the reference's butterfly_p run in Pallas
interpret mode (slow tier: it compiles the interpret-mode kernel); the
whole transform radix2_ntt's plain version against a DFT over host ints
(the Domain's transforms against the reference's radix-2 plan, coset
included, are tests/test_torch_ntt.py's); and, with the kernel binding
stubbed (meta tensors stand in for CUDA ones), the launches of a whole
transform: at most two up to 2^13. Tolerance: exact equality (canonical
Montgomery words)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu import config
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch import cuda
from gnark_tpu_torch.ntt import radix2
from gnark_tpu_torch.ntt.radix2 import (Radix2, butterfly, ntt_launches,
                                        radix2_ntt, stage_twiddles)

torch.set_num_threads(2)

FR = "bn254_fr"


def _stage(k, s, seed, lazy=0):
    """(values as host ints, words with the first `lazy` pushed into
    [p, 2p), the stage's twiddle words) for stage s of 2^k points."""
    f = get_ff(FR)
    q = f.p.modulus
    rng = random.Random(seed)
    n = 1 << k
    vals = [rng.randrange(q) for _ in range(n)]
    mont = [v * f.p.R_mod % q for v in vals]
    mont = [v + q if i < lazy else v for i, v in enumerate(mont)]
    y = torch.as_tensor(f.encode_words(mont, mont=False))
    tw = stage_twiddles(f, n, f.p.root_of_unity(n))[s - 1]
    return vals, y, torch.as_tensor(tw)


@pytest.mark.parametrize("s", [1, 3, 6])
def test_butterfly_plain_matches_host(s):
    k = 6
    f = get_ff(FR)
    q = f.p.modulus
    vals, y, tw = _stage(k, s, s, lazy=9)
    out = butterfly(f, y, tw)                     # CPU: the plain version
    assert out is y
    half = 1 << (s - 1)
    wm = pow(f.p.root_of_unity(1 << k), (1 << k) >> s, q)
    want = list(vals)
    for blk in range(0, 1 << k, 2 * half):
        for j in range(half):
            e, o = vals[blk + j], vals[blk + j + half] * pow(wm, j, q) % q
            want[blk + j], want[blk + j + half] = (e + o) % q, (e - o) % q
    assert [int(v) for v in f.decode_words(out)] == want


def test_butterfly_rejects_bad_shapes():
    f = get_ff(FR)
    _, y, tw = _stage(4, 2, 1)
    with pytest.raises(ValueError):
        butterfly(f, y[:6], tw)                   # 6 is not a multiple of 4
    with pytest.raises(ValueError):
        butterfly(f, y, tw[:1].expand(3, -1))     # half not a power of 2


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("GNARK_TPU_PALLAS", "1")
    config.use_pallas.cache_clear()
    yield
    config.use_pallas.cache_clear()


@pytest.mark.slow
@pytest.mark.parametrize("s", [1, 4, 7])
def test_butterfly_plain_matches_reference_kernel(s, pallas_on):
    from gnark_tpu.ff.pallas_ops import butterfly_p
    k = 7
    f, r = get_ff(FR), ref_get_ff(FR)
    _, y, tw = _stage(k, s, 10 + s)
    half, n = 1 << (s - 1), 1 << k
    limbs = f.from_words(y).numpy().reshape(n // (2 * half), 2 * half, f.n)
    even = jnp.asarray(limbs[:, :half].reshape(-1, f.n).astype(np.uint32))
    odd = jnp.asarray(limbs[:, half:].reshape(-1, f.n).astype(np.uint32))
    rtw = jnp.asarray(f.from_words(tw).numpy().astype(np.uint32))
    ev, od = butterfly_p(r, even, odd, rtw, half)
    want = np.concatenate([np.asarray(ev).reshape(-1, half, f.n),
                           np.asarray(od).reshape(-1, half, f.n)], axis=1)
    got = f.from_words(butterfly(f, y, tw)).numpy()
    assert np.array_equal(got, want.reshape(n, f.n).astype(np.int64))


@pytest.mark.parametrize("k", range(1, 9))
def test_radix2_ntt_plain_matches_dft(k):
    """Forward and inverse, a quarter of the inputs in [p, 2p)."""
    f = get_ff(FR)
    q = f.p.modulus
    n = 1 << k
    rng = random.Random(20 + k)
    vals = [rng.randrange(q) for _ in range(n)]
    mont = [v * f.p.R_mod % q for v in vals]
    x = torch.as_tensor(f.encode_words(mont, mont=False))
    for i in range(0, n, 4):               # encode_words would reduce v + q
        lazy = (mont[i] + q).to_bytes(32, "little")
        x[i] = torch.frombuffer(bytearray(lazy), dtype=torch.int32)
    w = f.p.root_of_unity(n)
    for ww in (w, pow(w, -1, q)):
        tw = torch.as_tensor(np.concatenate(stage_twiddles(f, n, ww)))
        got = [int(v) for v in f.decode_words(radix2_ntt(f, x, tw))]
        assert got == [sum(v * pow(ww, i * j, q) for j, v in enumerate(vals))
                       % q for i in range(n)]


class _Kernel:
    """Stands in for a ctypes kernel entry point: records the calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("k", range(1, 17))
def test_radix2_plan_launches(k, monkeypatch):
    """A Radix2 plan on a card's tensor launches the shared-memory kernel
    once (the first min(k, 10) stages) and one register pass for each
    further three stages: at most two launches up to 2^13."""
    monkeypatch.setattr(cuda, "dev_words", lambda t, what, shape=None: t)
    monkeypatch.setattr(cuda, "stream", lambda t: 0)
    seg, pas = _Kernel(), _Kernel()
    monkeypatch.setattr(radix2, "_seg_fn", lambda field: seg)
    monkeypatch.setattr(radix2, "_pass_fn", lambda field: pas)
    f = get_ff(FR)
    n = 1 << k
    plan = Radix2.__new__(Radix2)
    plan.ff, plan.n = f, n
    plan.tw = torch.empty((n - 1, 8), dtype=torch.int32, device="meta")
    before = radix2_ntt.launches
    y = plan(torch.empty((n, 8), dtype=torch.int32, device="meta"))
    assert y.shape == (n, 8)
    launches = radix2_ntt.launches - before
    assert launches == ntt_launches(n) == 1 + len(pas.calls)
    assert launches <= 2 or n > 1 << 13
    assert [c[3] for c in seg.calls] == [k]
    stages = [(c[3], c[4]) for c in pas.calls]      # (s0, r) of each pass
    assert sum(r for _, r in stages) == max(k - 10, 0)
    assert all(s0 == min(k, 10) + 3 * i for i, (s0, _) in enumerate(stages))
