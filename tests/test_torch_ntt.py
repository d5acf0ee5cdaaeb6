"""gnark_tpu_torch.ntt against the reference: Domain.fft / ifft, with
and without coset, against the reference Domain at 2^1 - 2^10 (the
four-step plan at every size; test_torch_fourstep.py holds the plan
itself against the reference FourStep). Tolerance: exact equality
(canonical Montgomery)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ntt import Domain

torch.set_num_threads(2)

FR = "bn254_fr"


def _vals(n, seed):
    q = get_ff(FR).p.modulus
    rng = random.Random(seed)
    return [rng.randrange(q) for _ in range(n)]


@pytest.mark.parametrize("k", range(1, 11))
def test_domain_matches_reference(k):
    n = 1 << k
    f, r = get_ff(FR), ref_get_ff(FR)
    dom, ref = Domain(f, n, "cpu"), RefDomain(r, n)
    v = _vals(n, k)
    x = torch.as_tensor(f.encode_words(v))
    rx = jnp.asarray(r.encode(v))
    for coset in (False, True):
        got = f.from_words(dom.fft(x, coset=coset)).numpy()
        assert np.array_equal(got, np.asarray(ref.fft(rx, coset=coset)))
        got = f.from_words(dom.ifft(x, coset=coset)).numpy()
        assert np.array_equal(got, np.asarray(ref.ifft(rx, coset=coset)))
