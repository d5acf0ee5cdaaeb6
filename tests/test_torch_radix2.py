"""Kernel K5 butterfly's plain version: one radix-2 DIT stage against
the stage written out with host ints (inputs in [p, 2p) included), and
against the reference's butterfly_p run in Pallas interpret mode (slow
tier: it compiles the interpret-mode kernel). Tolerance: exact equality
(canonical Montgomery words)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu import config
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ntt.radix2 import butterfly, stage_twiddles

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
