"""gnark_tpu_torch.ntt against the reference: Domain.fft / ifft, with
and without coset, against the reference Domain at 2^1 - 2^10, on the
port's default plan for those sizes (radix-2, kernel K5's plain version)
and with the four-step plan forced through GNARK_TPU_NTT_FOURSTEP_LOG
(kernel K2's plain twin, the coset and n^-1 scalings taken into the
plan; n = 2 stays radix-2, as in the reference); and, with the kernel
bindings stubbed (meta tensors stand in for CUDA ones), the launches of a
four-step transform on the card: two K2 launches with the scalings in
them and no K1, one more a global pass for rows past the shared-memory
cap. test_torch_fourstep.py holds the four-step plan itself against the
reference FourStep. Tolerance: exact equality (canonical Montgomery)."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff.mont_mul import mont_mul
from gnark_tpu_torch.ntt import Domain, fourstep
from gnark_tpu_torch.ntt.fourstep import FourStep, fourstep_ntt
from gnark_tpu_torch.ntt.radix2 import Radix2

torch.set_num_threads(2)

FR = "bn254_fr"


def _vals(n, seed):
    q = get_ff(FR).p.modulus
    rng = random.Random(seed)
    return [rng.randrange(q) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference(k):
    """The reference Domain's four transforms of _vals(2^k, k)."""
    r = ref_get_ff(FR)
    ref = RefDomain(r, 1 << k)
    rx = jnp.asarray(r.encode(_vals(1 << k, k)))
    return tuple(np.asarray(f(rx, coset=c)) for c in (False, True)
                 for f in (ref.fft, ref.ifft))


# ids "1".."10" are the radix-2 cases, "fourstep-k" the forced plan
CASES = [pytest.param(k, False, id=str(k)) for k in range(1, 11)] + \
    [pytest.param(k, True, id=f"fourstep-{k}") for k in range(2, 11)]


@pytest.mark.parametrize("k, fourstep", CASES)
def test_domain_matches_reference(k, fourstep, monkeypatch):
    if fourstep:
        monkeypatch.setenv("GNARK_TPU_NTT_FOURSTEP_LOG", "1")
    n = 1 << k
    f = get_ff(FR)
    dom = Domain(f, n, "cpu")
    plan = FourStep if fourstep and n >= 4 else Radix2
    assert isinstance(dom._plan(False), plan)
    x = torch.as_tensor(f.encode_words(_vals(n, k)))
    got = tuple(f.from_words(g(x, coset=c)).numpy() for c in (False, True)
                for g in (dom.fft, dom.ifft))
    for g, w in zip(got, _reference(k)):
        assert np.array_equal(g, w)


class _Kernel:
    """Stands in for a ctypes kernel entry point: records the calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("k, cap, passes", [
    (6, 12, 0), (9, 12, 0), (9, 3, 2), (10, 2, 2), (10, 1, 4)])
def test_fourstep_launches(k, cap, passes, monkeypatch):
    """fft / ifft, plain and coset, on a FourStep plan: each transform is
    two K2 launches (plus one a global pass when a row is longer than
    2^cap) with the coset powers as pass 1's pre-scale and n^-1 (or n^-1
    g^-i) as pass 2's post-scale, and no K1 launch."""
    monkeypatch.setenv("GNARK_TPU_NTT_FOURSTEP_LOG", "1")
    monkeypatch.setattr(fourstep, "SMEM_LOG", cap)
    monkeypatch.setattr(cuda, "dev_words", lambda t, what, shape=None: t)
    monkeypatch.setattr(cuda, "stream", lambda t: 0)
    seg, pas = _Kernel(), _Kernel()
    monkeypatch.setattr(fourstep, "_seg_fn", lambda field: seg)
    monkeypatch.setattr(fourstep, "_pass_fn", lambda field: pas)
    f = get_ff(FR)
    n = 1 << k
    dom = Domain(f, n, "cpu")
    x = torch.empty((n, f.nw), dtype=torch.int32, device="meta")
    k0, m0 = fourstep_ntt.launches, mont_mul.launches
    for g, coset in ((dom.fft, False), (dom.fft, True), (dom.ifft, False),
                     (dom.ifft, True)):
        seg.calls.clear()
        pas.calls.clear()
        assert g(x, coset=coset).shape == (n, f.nw)
        assert len(seg.calls) == 2 and len(pas.calls) == passes
        # pass 1's first launch takes the pre-scale, pass 2's last the
        # post-scale
        long1 = bool(dom._plan(g == dom.ifft).rplan[0][0])
        pre = (pas.calls[0] if long1 else seg.calls[0])[1]
        post = seg.calls[1][3]
        assert all(c[1] == 0 for c in pas.calls[1:])
        if g == dom.fft:
            assert (pre != 0) == coset and post == 0
            assert seg.calls[1][14] == 0                 # no broadcast
        else:
            assert pre == 0 and post != 0
            assert seg.calls[1][14] == int(not coset)    # n^-1 broadcast
    assert fourstep_ntt.launches - k0 == 4 * (2 + passes)
    assert mont_mul.launches == m0
