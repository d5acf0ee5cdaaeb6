"""The plain versions of K10-K13 (gnark_tpu_torch/ff/ops.py) and the
port's FF.batch_inv against the reference on the CPU: FF.add / FF.sub,
FF.batch_inv, jax.lax.associative_scan(ff.mul) and plonk_device's
ff_sum / dev_powers / dev_poly_eval, on the same seeded inputs (zeros,
one row, rows not a power of two), and the wrappers' argument checks.
The kernels themselves are held against these on the card
(tests/test_torch_cuda.py::test_ff_ops, chip_smoke.py).
Tolerance: exact equality (canonical Montgomery words)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.backend import plonk_device as ref_pdev
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu_torch import cuda
from gnark_tpu_torch.backend import plonk_device as pdev
from gnark_tpu_torch.ff import get_ff, ops

NAME = "bn254_fr"
SIZES = [1, 37]

torch.set_num_threads(2)


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    q = get_ff(NAME).p.modulus
    v = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    for i in range(0, n, 7):
        v[i] = 0
    return v


BASE = _vals(2, 5)[1]


def _pair(vals):
    f, rf = get_ff(NAME), ref_get_ff(NAME)
    return torch.as_tensor(f.encode_words(vals)), jnp.asarray(rf.encode(vals))


def _words(ref_limbs):
    f = get_ff(NAME)
    return f.to_words(torch.as_tensor(np.asarray(ref_limbs).astype(np.int64)))


@pytest.fixture(scope="module")
def ref():
    """The reference's results on _vals(n, n), _vals(n, n + 1) for each n
    of SIZES, and its powers of BASE: one jitted program a size (its
    eager ops would compile one by one)."""
    rf = ref_get_ff(NAME)

    def run(ra, rb):
        return dict(
            add=rf.add(ra, rb), sub=rf.sub(ra, rb),
            sub1=rf.sub(ra, jnp.broadcast_to(rb[-1:], ra.shape)),
            inv=rf.batch_inv(ra),
            scan=jax.lax.associative_scan(rf.mul, ra, axis=0),
            dot=ref_pdev.ff_sum(rf, rf.mul(ra, rb))[None],
            sum=ref_pdev.ff_sum(rf, ra)[None])

    out = {n: jax.jit(run)(_pair(_vals(n, n))[1], _pair(_vals(n, n + 1))[1])
           for n in SIZES}
    powers = jax.jit(ref_pdev.dev_powers, static_argnums=(0, 1, 2))
    out["powers"] = {n: powers(rf, BASE, n) for n in (1, 40)}
    return out


@pytest.mark.parametrize("n", SIZES)
def test_plain_ops_equal_reference(n, ref):
    f = get_ff(NAME)
    a, _ = _pair(_vals(n, n))
    b, _ = _pair(_vals(n, n + 1))
    want = {k: _words(v) for k, v in ref[n].items()}
    assert torch.equal(ops.add(f, a, b), want["add"])
    assert torch.equal(ops.sub(f, a, b), want["sub"])
    assert torch.equal(ops.sub(f, a, b[-1:]), want["sub1"])
    assert torch.equal(ops.batch_inv(f, a), want["inv"])
    assert torch.equal(ops.scan_mul(f, a), want["scan"])
    assert torch.equal(ops.dot(f, a, b), want["dot"])
    assert torch.equal(pdev.ff_sum(f, a), want["sum"])


def test_plain_ops_take_lazy_inputs():
    """Inputs in [p, 2p) (the raw words of x + p) give the canonical
    results of x."""
    f = get_ff(NAME)
    q = f.p.modulus
    vals = [v * f.p.R_mod % q for v in _vals(37, 9)]
    raw = b"".join((v + q).to_bytes(32, "little") for v in vals)
    lazy = torch.from_numpy(np.frombuffer(raw, dtype=np.int32)
                            .reshape(-1, 8).copy())
    canon = torch.as_tensor(f.encode_words(vals, mont=False))
    for fn in (ops.batch_inv, ops.scan_mul, ops.dot):
        assert torch.equal(fn(f, lazy), fn(f, canon))
    assert torch.equal(ops.add(f, lazy, lazy), ops.add(f, canon, canon))
    assert torch.equal(ops.sub(f, lazy, canon), torch.zeros_like(lazy))


def test_powers_and_evaluation_equal_reference(ref):
    f, rf = get_ff(NAME), ref_get_ff(NAME)
    for n in (1, 40):
        assert torch.equal(pdev.dev_powers(f, BASE, n, "cpu"),
                           _words(ref["powers"][n]))
    c, rc = _pair(_vals(37, 6))
    zp = pdev.dev_powers(f, BASE, 40, "cpu")
    assert pdev.dev_poly_eval(f, c, zp) == ref_pdev.dev_poly_eval(
        rf, rc, ref["powers"][40])


def test_wrappers_check_their_arguments():
    f = get_ff(NAME)
    a, _ = _pair(_vals(4, 1))
    with pytest.raises(ValueError):
        ops.add(f, a, a[:2])
    with pytest.raises(ValueError):
        ops.dot(f, a, a[:1])
    with pytest.raises(ValueError):
        ops.scan_mul(f, a.reshape(-1))
    with pytest.raises(ValueError):
        ops.dot(f, a[:0])
    # K12's scratch: tiles of 8192 rows; K11's: tiles of 2048 at most
    assert ops.scan_tiles(1) == 1
    assert ops.scan_tiles(8192) == 1
    assert ops.scan_tiles(8193) == 2
    assert ops.scan_tiles(1 << 20) == 128
    assert ops.inv_tiles(2049) == 2
    assert ops.inv_tiles(1 << 21) == 1024


def test_card_halves_hand_the_kernels_zeroed_state(monkeypatch):
    """K12's look-back needs its ticket and a flag a tile zero, then two
    value rows a tile; K11 two scratch rows a tile: the card halves'
    arguments, read through the pointers by a stub binding (CPU tensors
    stand in for the card's)."""
    f = get_ff(NAME)
    seen = {}

    def stub(name, field):
        def call(*args):
            n = args[-3]
            if name == "gt_scan_mul":
                seen[name] = (n, ctypes.string_at(
                    args[2], 4 * ops.scan_scratch_words(n)))
            else:
                seen[name] = (n,)
            return 0
        return call

    monkeypatch.setattr(ops, "_fn", stub)
    monkeypatch.setattr(cuda, "stream", lambda t: 0)
    n = 3 * ops.SCAN_TILE + 1
    a = torch.zeros((n, f.nw), dtype=torch.int32)
    assert ops._scan_mul_card(f, a).shape == a.shape
    assert ops.scan_scratch_words(n) == 8 + 2 * 4 * 8
    assert seen["gt_scan_mul"] == (n, bytes(4 * (8 + 2 * 4 * 8)))
    assert ops.scan_scratch_words(1) == 8 + 2 * 8
    assert ops._batch_inv_card(f, a).shape == a.shape
    assert seen["gt_batch_inv"] == (n,)
