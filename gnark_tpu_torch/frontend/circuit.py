"""Circuit definition, schema walk, and compile().

Analog of the reference's `frontend.Compile` + `frontend/schema`
(frontend/compile.go:38-98 CompileGeneric, schema/walk.go): we reflect
over a user circuit object's annotations, allocate public wires first
then secret (compile.go:136-146 leaf ordering), call the user's
`define(api)`, and return the finalized ConstraintSystem.

Usage:

    class Cubic(Circuit):
        x: Secret
        y: Public
        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(api.add(x3, self.x, 5), self.y)

    cs = compile_circuit(Cubic(), fields.BN254_FR)
    w = witness(Cubic(x=3, y=35), cs)   # ordered (public, secret) values

Arrays: annotate with list[Secret] / list[Public] (nested lists fine)
and pre-size the attribute in __init__ (like gnark's pre-allocated
slices, e.g. `make([]frontend.Variable, n)`).
"""

from __future__ import annotations

import typing

from gnark_tpu_torch.constraint.system import ConstraintSystem
from gnark_tpu_torch.fields import FieldParams
from gnark_tpu_torch.frontend.r1cs import R1CSBuilder
from gnark_tpu_torch.frontend.variable import Variable


class Public:
    """Annotation marker: public input (instance of gnark `gnark:",public"`)."""


class Secret:
    """Annotation marker: secret witness (gnark default visibility)."""


class Circuit:
    """Base class for user circuits. Subclasses define leaves via
    annotations and implement define(api)."""

    def __init__(self, **assignments):
        for k, v in assignments.items():
            setattr(self, k, v)

    def define(self, api) -> None:
        raise NotImplementedError


def _leaf_visibility(ann):
    """'public' / 'secret' / None for an annotation."""
    if ann is Public:
        return "public"
    if ann is Secret:
        return "secret"
    return None


def _walk(circuit, want: str, visit):
    """Visit leaves of `circuit` with visibility `want` in declaration
    order. visit(name, get, set) where get()/set(v) access the slot."""
    anns = typing.get_type_hints(type(circuit))
    for name, ann in anns.items():
        _walk_slot(
            circuit, name, ann, f"{name}", want, visit,
            lambda obj=circuit, n=name: getattr(obj, n, None),
            lambda v, obj=circuit, n=name: setattr(obj, n, v),
        )


def _walk_slot(parent, name, ann, path, want, visit, get, set_):
    vis = _leaf_visibility(ann)
    if vis is not None:
        if vis == want:
            visit(path, get, set_)
        return
    origin = typing.get_origin(ann)
    if origin in (list, tuple):
        (elem_ann,) = typing.get_args(ann) or (Secret,)
        val = get()
        if val is None:
            raise ValueError(
                f"{path}: list field must be pre-sized (assign a list of "
                f"values or Nones before compile)")
        for i in range(len(val)):
            _walk_slot(
                parent, name, elem_ann, f"{path}[{i}]", want, visit,
                lambda v=val, j=i: v[j],
                lambda x, v=val, j=i: v.__setitem__(j, x),
            )
        return
    if isinstance(ann, type) and hasattr(ann, "__annotations__") \
            and not issubclass(ann, (int, str, float)):
        sub = get()
        if sub is None:
            raise ValueError(f"{path}: nested struct not initialized")
        sub_anns = typing.get_type_hints(ann)
        for sub_name, sub_ann in sub_anns.items():
            _walk_slot(
                sub, sub_name, sub_ann, f"{path}.{sub_name}", want, visit,
                lambda o=sub, n=sub_name: getattr(o, n, None),
                lambda v, o=sub, n=sub_name: setattr(o, n, v),
            )
        return
    # non-circuit field (plain config attribute): ignored


def compile_circuit(circuit: Circuit, field: FieldParams,
                    builder_cls=R1CSBuilder,
                    check_unconstrained: bool = False) -> ConstraintSystem:
    """Compile: allocate wires (public then secret), run define().

    check_unconstrained=True errors when a secret input appears in no
    constraint/hint (the reference errors by DEFAULT unless
    IgnoreUnconstrainedInputs is passed; here the check is opt-in
    because dummy anchor fields are idiomatic in the test corpus)."""
    builder = builder_cls(field)

    def alloc_public(path, get, set_):
        set_(builder.public_variable(path))

    def alloc_secret(path, get, set_):
        set_(builder.secret_variable(path))

    _walk(circuit, "public", alloc_public)
    _walk(circuit, "secret", alloc_secret)
    circuit.define(builder)
    # deferred callbacks (reference frontend/compile.go:166 callDeferred)
    while getattr(builder, "deferred", None):
        fn = builder.deferred.pop(0)
        fn(builder)
    cs = builder.cs
    if check_unconstrained:
        used = set()
        for con in cs.r1cs:
            for e in (con.l, con.r, con.o):
                used.update(w for _c, w in e)
        for con in cs.sparse:
            used.update((con.xa, con.xb, con.xo))
        for inst in cs.instructions:
            if inst.kind == "hint":
                for e in inst.inputs:
                    used.update(w for _c, w in e)
        for w in range(cs.nb_public, cs.nb_public + cs.nb_secret):
            if w not in used:
                raise ValueError(
                    f"secret input wire {w} is unconstrained "
                    "(pass check_unconstrained=False to allow)")
    return cs


def witness(assigned: Circuit, cs: ConstraintSystem):
    """Extract (public_values, secret_values) from an assigned instance,
    in the same order compile_circuit allocated wires."""
    q = cs.q
    pub, sec = [], []

    def collect(into):
        def visit(path, get, set_):
            v = get()
            if v is None or not isinstance(v, int):
                raise ValueError(f"{path}: missing assignment")
            into.append(int(v) % q)
        return visit

    _walk(assigned, "public", collect(pub))
    _walk(assigned, "secret", collect(sec))
    if len(pub) != cs.nb_public - 1 or len(sec) != cs.nb_secret:
        raise ValueError("assignment shape does not match compiled circuit")
    return pub, sec
