"""gnark_tpu_torch Groth16 prove against the reference and the
known-log / Schwartz-Zippel checks; the port's import boundary.

Tolerance: exact equality (the same R1CS, the same Proof under the same
random.Random seed)."""

import ast
import pathlib
import random

import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import groth16 as ref_groth16
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu_torch import fields
from gnark_tpu_torch.backend import groth16
from gnark_tpu_torch.backend.groth16_check import (check_prove,
                                                   known_log_key,
                                                   synth_square_chain)
from gnark_tpu_torch.constraint import SolverError
from gnark_tpu_torch.ec import curves
from gnark_tpu_torch.frontend import (Circuit, Public, Secret,
                                      compile_circuit, witness)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Cubic(Circuit):
    x: Secret
    y: Public

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


class RefCubic(RefCircuit):
    x: RefSecret
    y: RefPublic

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


def _key_arrays(pk):
    """The reference ProvingKey as plain data (numpy and host ints)."""
    d = {k: getattr(pk, k) for k in ("domain_n", "g1_alpha", "g1_beta",
                                     "g1_delta", "g2_beta", "g2_delta")}
    for k in ("g1_a", "g1_b", "g1_z", "g1_k", "g2_b"):
        d[k] = tuple(np.asarray(a) for a in getattr(pk, k))
    return d


def test_compile_cubic_same_r1cs():
    cs = compile_circuit(Cubic(), fields.BN254_FR)
    ref = ref_compile(RefCubic(), ref_fields.BN254_FR)
    assert [(c.l, c.r, c.o) for c in cs.r1cs] == \
        [(c.l, c.r, c.o) for c in ref.r1cs]
    assert (cs.nb_public, cs.nb_secret, cs.nb_internal) == \
        (ref.nb_public, ref.nb_secret, ref.nb_internal)
    assert [(i.kind, i.cidx, i.outputs) for i in cs.instructions] == \
        [(i.kind, i.cidx, i.outputs) for i in ref.instructions]
    assert witness(Cubic(x=3, y=35), cs) == \
        ref_witness(RefCubic(x=3, y=35), ref)
    from gnark_tpu_torch.frontend.scs import SCSBuilder
    scs = compile_circuit(Cubic(), fields.BN254_FR, builder_cls=SCSBuilder)
    assert scs.kind == "scs" and not scs.r1cs and scs.sparse


@pytest.mark.slow
def test_prove_cubic_equals_reference():
    """Reference setup -> the port's prove on the carried-over key ->
    the same Proof as the reference's prove, accepted by the reference
    verify."""
    ref_cs = ref_compile(RefCubic(), ref_fields.BN254_FR)
    pk, vk = ref_groth16.setup(ref_cs, "bn254", rng=random.Random(42))
    pub, sec = ref_witness(RefCubic(x=3, y=35), ref_cs)
    want = ref_groth16.prove(ref_cs, pk, pub, sec, rng=random.Random(1))
    cs = compile_circuit(Cubic(), fields.BN254_FR)
    tpk = groth16.proving_key_from_arrays(_key_arrays(pk), device="cpu")
    got = groth16.prove(cs, tpk, pub, sec, rng=random.Random(1),
                        device="cpu")
    assert (got.ar, got.krs, got.bs, got.commitments, got.poks) == \
        (want.ar, want.krs, want.bs, want.commitments, want.poks)
    assert ref_groth16.verify(
        ref_groth16.Proof(ar=got.ar, krs=got.krs, bs=got.bs), vk, pub)


def test_wrong_witness_raises():
    cs = compile_circuit(Cubic(), fields.BN254_FR)
    pk = groth16.dummy_setup(cs, "bn254", device="cpu")
    pub, sec = witness(Cubic(x=3, y=36), cs)
    with pytest.raises(SolverError):
        groth16.prove(cs, pk, pub, sec, rng=random.Random(1), device="cpu")


def test_prove_rejects_what_is_not_ported():
    cs = compile_circuit(Cubic(), fields.BN254_FR)
    pk = groth16.dummy_setup(cs, "bn254", device="cpu")
    pub, sec = witness(Cubic(x=3, y=35), cs)
    with pytest.raises(NotImplementedError):
        groth16.prove(cs, pk, pub, sec, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            groth16.dummy_setup(cs, "bn254")       # default: the card
        with pytest.raises(RuntimeError):
            groth16.prove(cs, pk, pub, sec)
    # a commitment key the circuit has no commitment for, under the
    # default and the MiMC commitment hashes (ported, tests/
    # test_torch_plonk.py::test_groth16_recursion_hashes_equal_reference)
    pk.commitment_keys = [object()]
    for mode in (False, True, "self"):
        with pytest.raises(ValueError):
            groth16.prove(cs, pk, pub, sec, recursion_friendly=mode,
                          device="cpu")


@pytest.mark.slow
def test_chain_known_log_key_checks():
    """A 2^8-constraint squaring chain on a known-log key: the five MSMs
    of prove's own stages equal (sum k_i s_i) G, and H passes
    Schwartz-Zippel. Slow tier: five plain MSM epilogues take ~20 s on
    a CPU; chip_smoke.py makes the same check at 2^20 on the card."""
    cs = synth_square_chain(16, 16)
    pk = known_log_key(cs, curves.CURVES["bn254"], "cpu")
    assert pk.domain_n == 256
    check_prove(cs, pk, [], [j + 2 for j in range(16)], random.Random(3))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "gnark_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "ff_ops_times.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top != "jax" and top != "jaxlib", (f, mod)
            assert mod != "gnark_tpu" and not mod.startswith("gnark_tpu."), \
                (f, mod)
