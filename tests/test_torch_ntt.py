"""gnark_tpu_torch.ntt against the reference: Domain.fft / ifft, with
and without coset, against the reference Domain at 2^1 - 2^10, on the
port's default plan for those sizes (radix-2, kernel K5's plain version)
and with the four-step plan forced through GNARK_TPU_NTT_FOURSTEP_LOG
(kernels K2 and K1; n = 2 stays radix-2, as in the reference).
test_torch_fourstep.py holds the four-step plan itself against the
reference FourStep. Tolerance: exact equality (canonical Montgomery)."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ntt import Domain
from gnark_tpu_torch.ntt.fourstep import FourStep
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
