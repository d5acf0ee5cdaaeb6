"""The plain four-step plan (kernels K2 and K1 in their plain
versions) against the reference FourStep, whose Pallas kernels run in
interpret mode on the CPU; the plain row FFT against a naive DFT.
Tolerance: exact equality (canonical Montgomery)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu.ntt.fourstep import FourStep as RefFourStep
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ntt import get_domain
from gnark_tpu_torch.ntt.fourstep import (FourStep, bitrev, root_powers,
                                          row_fft)

torch.set_num_threads(2)

FR = "bn254_fr"


def _vals(n, seed):
    q = get_ff(FR).p.modulus
    rng = random.Random(seed)
    return [rng.randrange(q) for _ in range(n)]


@pytest.mark.slow
@pytest.mark.parametrize("n", [1 << 6, 1 << 7])
def test_fourstep_plain_matches_reference(n):
    """Even and odd log2(n): rows of S = n1 and of S != n1. Slow tier:
    the reference's interpret-mode kernels compile for minutes; the port's
    Domain, which always runs this plan, is held against the reference
    Domain at 2^1-2^10 in test_torch_ntt.py."""
    f, r = get_ff(FR), ref_get_ff(FR)
    dom = RefDomain(r, n)
    v = _vals(n, n)
    x = torch.as_tensor(f.encode_words(v))
    rx = jnp.asarray(r.encode(v))
    for w in (dom.omega, dom.omega_inv):
        got = f.from_words(FourStep(f, n, w, "cpu")(x)).numpy()
        assert np.array_equal(got, np.asarray(RefFourStep(r, n, w)(rx)))


def test_row_fft_plain_is_bit_reversed_dft():
    f = get_ff(FR)
    q = f.p.modulus
    S, rows = 16, 3
    w = f.p.root_of_unity(S)
    v = _vals(S * rows, 5)
    x = torch.as_tensor(f.encode_words(v)).reshape(rows, S, f.nw)
    pw = torch.as_tensor(root_powers(f, S, w))
    got = f.decode_words(row_fft(f, x, pw))       # CPU: the plain version
    rev = bitrev(S)
    for r_ in range(rows):
        row = v[r_ * S:(r_ + 1) * S]
        for pos in range(S):
            k = int(rev[pos])
            want = sum(c * pow(w, j * k, q) for j, c in enumerate(row)) % q
            assert int(got[r_, pos]) == want


def test_get_domain_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the error path of a machine without CUDA")
    with pytest.raises(RuntimeError):
        get_domain(get_ff(FR), 8)
    assert get_domain(get_ff(FR), 8, "cpu") is get_domain(get_ff(FR), 8,
                                                          "cpu")
