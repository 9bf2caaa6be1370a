"""The port's wire format for every value type and for evaluation contexts,
against the JAX package's protobuf bytes.

`ValueType` and `Value` of `IntModNType` (the modulus a `Value.Integer`)
and `TupleType` (nested tuples included), keys carrying their value
corrections, and `EvaluationContext`s before and after hierarchical
evaluation (partial evaluations sorted by prefix): the port's
`serialize_*` must give the bytes of the JAX package's
`*_to_proto(...).SerializeToString()`, and the port's `parse_*` must read
protobuf's bytes, any proto3 encoding of them, back to equal objects.
Host code, plus the port's plain versions on the CPU for the evaluation
that fills a context; the JAX side runs protobuf and its key generation,
no XLA program.
"""

from unittest import mock

import numpy as np
import pytest

from distributed_point_functions_tpu import dpf as jdpf
from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu import value_types as jvt
from distributed_point_functions_tpu.protos import dpf_pb2
from distributed_point_functions_tpu_torch import dpf as tdpf
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch import serialization as ser
from distributed_point_functions_tpu_torch import value_types as tvt
from distributed_point_functions_tpu_torch.ops import aes
from distributed_point_functions_tpu_torch.ops.words import to_numpy

P32 = 4294967291


def _to_port(t):
    if isinstance(t, jvt.IntType):
        return tvt.IntType(t.bits)
    if isinstance(t, jvt.XorType):
        return tvt.XorType(t.bits)
    if isinstance(t, jvt.IntModNType):
        return tvt.IntModNType(t.base_bits, t.modulus)
    return tvt.TupleType([_to_port(e) for e in t.elements])


TYPES = [
    jvt.IntModNType(32, P32),
    jvt.IntModNType(8, 251),
    jvt.IntModNType(64, (1 << 64) - 59),
    jvt.IntModNType(128, (1 << 128) - 159),
    jvt.IntModNType(16, 1),
    jvt.TupleType([jvt.IntType(32), jvt.IntModNType(32, P32)]),
    jvt.TupleType([jvt.XorType(128), jvt.IntType(8)]),
    jvt.TupleType([jvt.IntType(16), jvt.TupleType([jvt.IntModNType(64, 1 << 40),
                                                   jvt.TupleType([jvt.IntType(128)])])]),
]


def _values(t, rng):
    """Host values of type `t`: 0, the largest, and random ones."""
    if isinstance(t, jvt.TupleType):
        per = [_values(e, rng) for e in t.elements]
        return [tuple(v[i] for v in per) for i in range(4)]
    top = t.modulus if isinstance(t, jvt.IntModNType) else 1 << t.bits
    return [0, top - 1] + [int.from_bytes(rng.bytes(16), "little") % top for _ in range(2)]


@pytest.mark.parametrize("jt", TYPES, ids=str)
def test_value_types_and_values_match_protobuf(jt):
    tt = _to_port(jt)
    data = jser.value_type_to_proto(jt).SerializeToString()
    assert ser.serialize_value_type(tt) == data
    assert ser.parse_value_type(data) == tt
    for v in _values(jt, np.random.default_rng(len(data))):
        data = jser.value_to_proto(jt, v).SerializeToString()
        assert ser.serialize_value(tt, v) == data
        assert ser.parse_value(tt, data) == jser.value_from_proto(jt, dpf_pb2.Value.FromString(data))
        assert ser.parse_value(tt, data) == v


def test_parsers_read_other_encodings():
    """Repeated singular fields merge, unknown fields are skipped, a value
    of another kind reads as the default, a tuple of fewer elements
    shortens, and a type with no member set raises."""
    jt = jvt.TupleType([jvt.IntModNType(32, P32), jvt.IntType(64)])
    tt = _to_port(jt)
    data = jser.value_type_to_proto(jt).SerializeToString()
    extra = b"\x28\x07" + b"\x3a\x02\x08\x01"  # unknown varint and bytes fields
    for raw in (data + extra, extra + data, data + data[:0]):
        assert ser.parse_value_type(raw) == _to_port(
            jser.value_type_from_proto(dpf_pb2.ValueType.FromString(raw)))
    value = jser.value_to_proto(jt, (5, 7)).SerializeToString()
    other = jser.value_to_proto(jvt.IntType(32), 9).SerializeToString()
    short = dpf_pb2.Value()
    short.tuple.elements.add().int_mod_n.value_uint64 = 3
    for raw in (value + extra, value + other, other + value, short.SerializeToString(), b""):
        assert ser.parse_value(tt, raw) == jser.value_from_proto(jt, dpf_pb2.Value.FromString(raw))
    imn = jvt.IntModNType(32, P32)
    for raw in (value, other):
        assert ser.parse_value(_to_port(imn), raw) == jser.value_from_proto(
            imn, dpf_pb2.Value.FromString(raw))
    with pytest.raises(ValueError, match="no type set"):
        ser.parse_value_type(b"")
    with pytest.raises(ValueError):  # a modulus of 0
        ser.parse_value_type(b"\x1a\x04\x0a\x02\x08\x20")


def _jax_keys(jd, alpha, betas, seed):
    rng = np.random.default_rng(seed)
    with mock.patch.object(jdpf.secrets, "randbits",
                           lambda k: int.from_bytes(rng.bytes(k // 8), "little")):
        return jd.generate_keys_incremental(alpha, betas)


def _port_key(k):
    return interop.dpf_key_from_fields(
        k.seed, k.party,
        [(cw.seed, cw.control_left, cw.control_right, cw.value_correction)
         for cw in k.correction_words],
        k.last_level_value_correction)


HIERARCHY = [(3, TYPES[0]), (6, TYPES[5]), (9, jvt.IntType(64))]


def _pair():
    jd = jdpf.DistributedPointFunction.create_incremental(
        [jdpf.DpfParameters(l, t) for l, t in HIERARCHY])
    td = tdpf.DistributedPointFunction.create_incremental(
        [tdpf.DpfParameters(l, _to_port(t)) for l, t in HIERARCHY], device="cpu")
    return jd, td


def _context_fields(ctx):
    pe = ctx.partial_evaluations
    partial = []
    if pe is not None:
        seeds = aes.limbs_to_u128s(to_numpy(pe.seeds)[pe.rows])
        partial = list(zip([int(p) for p in pe.prefixes], seeds,
                           to_numpy(pe.control)[pe.rows].tolist()))
    return (ctx.key, ctx.previous_hierarchy_level, ctx.partial_evaluations_level, partial)


def test_keys_and_evaluation_contexts_match_protobuf():
    jd, td = _pair()
    alpha, betas = 0x1B5, [17, (3, P32 - 1), (1 << 64) - 1]
    jkeys = _jax_keys(jd, alpha, betas, 3)
    for jk in jkeys:
        tk = _port_key(jk)
        data = jser.key_to_proto(jd, jk).SerializeToString()
        assert ser.serialize_key(td, tk) == data
        assert ser.parse_key(td, data) == _port_key(
            jser.key_from_proto(jd, dpf_pb2.DpfKey.FromString(data)))
        # A fresh context, then after two hierarchy levels (the context
        # holds level 1's partial evaluations); the JAX context carries
        # the port's fields, so no XLA program runs.
        tctx = td.create_evaluation_context(tk)
        for step in range(2):
            if step:
                td.evaluate_next([], tctx)
                td.evaluate_next([0, 6, alpha >> 6, 3], tctx)
            key, prev, level, partial = _context_fields(tctx)
            jctx = jdpf.EvaluationContext(
                key=jk, previous_hierarchy_level=prev, partial_evaluations_level=level,
                partial_evaluations={p: (s, c) for p, s, c in reversed(partial)})
            data = jser.evaluation_context_to_proto(jd, jctx).SerializeToString()
            assert ser.serialize_evaluation_context(td, tctx) == data
            dpf, got = ser.parse_evaluation_context(data, device="cpu")
            assert dpf.parameters == td.parameters
            _, want = jser.evaluation_context_from_proto(
                dpf_pb2.EvaluationContext.FromString(data))
            want_partial = sorted((p, s, c) for p, (s, c) in want.partial_evaluations.items())
            assert _context_fields(got) == (
                _port_key(want.key), want.previous_hierarchy_level,
                want.partial_evaluations_level, want_partial)
            assert _context_fields(got) == _context_fields(tctx)
    # A parsed context resumes evaluation where the original left off.
    _, resumed = ser.parse_evaluation_context(
        ser.serialize_evaluation_context(td, tctx), device="cpu")
    last = [alpha >> 3, 5]
    a = td.evaluate_next(last, resumed)
    b = td.evaluate_next(last, tctx)
    assert np.array_equal(to_numpy(a), to_numpy(b))
