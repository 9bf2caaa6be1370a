"""The port's proto validator against the JAX package's, case by case.

Every case of the JAX package's `tests/test_proto_validator.py` (and a few
for the IntModN and tuple types) builds its messages with protobuf on the
JAX side; the JAX validator checks the message objects and the port's
validator the same messages' bytes. Both must accept, or both must raise
`ValueError` with the same message. Host code only: no XLA program runs
(keys come from the JAX package's host key generation).
"""

import pytest

from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.dpf import DistributedPointFunction, DpfParameters
from distributed_point_functions_tpu.proto_validator import ProtoValidator as JaxValidator
from distributed_point_functions_tpu.protos import dpf_pb2
from distributed_point_functions_tpu.value_types import IntType
from distributed_point_functions_tpu_torch.proto_validator import ProtoValidator


def _bytes(protos):
    return [p.SerializeToString() for p in protos]


def _params(*lds, bits=32):
    out = []
    for d in lds:
        p = dpf_pb2.DpfParameters()
        p.log_domain_size = d
        p.value_type.integer.bitsize = bits
        out.append(p)
    return out


def _mutated(mutate, *lds):
    ps = _params(*lds)
    mutate(ps)
    return ps


def _integer_value(v):
    out = dpf_pb2.Value()
    if v < 1 << 64:
        out.integer.value_uint64 = v
    else:
        out.integer.value_uint128.high = v >> 64
        out.integer.value_uint128.low = v & ((1 << 64) - 1)
    return out


def _vt(**kinds):
    vt = dpf_pb2.ValueType()
    for kind, bits in kinds.items():
        getattr(vt, kind).bitsize = bits
    return vt


def _int_mod_n_type(base, modulus):
    vt = dpf_pb2.ValueType()
    vt.int_mod_n.base_integer.bitsize = base
    vt.int_mod_n.modulus.value_uint64 = modulus
    return vt


def _tuple_type(*elements):
    vt = dpf_pb2.ValueType()
    for e in elements:
        vt.tuple.elements.add().CopyFrom(e)
    return vt


def _value(**kinds):
    v = dpf_pb2.Value()
    for kind, x in kinds.items():
        getattr(v, kind).value_uint64 = x
    return v


def _tuple_value(*elements):
    v = dpf_pb2.Value()
    for e in elements:
        v.tuple.elements.add().CopyFrom(e)
    return v


def _key_fixture(lds=6):
    dpf = DistributedPointFunction.create(DpfParameters(log_domain_size=lds, value_type=IntType(32)))
    k0, _ = dpf.generate_keys(3, 42)
    return [jser.parameters_to_proto(p) for p in dpf.parameters], jser.key_to_proto(dpf, k0)


def _two_level():
    dpf = DistributedPointFunction.create_incremental(
        [DpfParameters(log_domain_size=3, value_type=IntType(32)),
         DpfParameters(log_domain_size=9, value_type=IntType(32))])
    return dpf, dpf.generate_keys_incremental(100, [1, 2])


def _key_case(mutate=None):
    params, key = _key_fixture()
    if mutate:
        mutate(key)
    return "key", params, key


def _intermediate_vc(clear):
    dpf, (k0, _) = _two_level()
    key = jser.key_to_proto(dpf, k0)
    if clear:
        key.correction_words[dpf._hierarchy_to_tree[0]].ClearField("value_correction")
    return "key", [jser.parameters_to_proto(p) for p in dpf.parameters], key


def _ctx_case(mutate=None):
    dpf, (k0, _) = _two_level()
    ctx = jser.evaluation_context_to_proto(dpf, dpf.create_evaluation_context(k0))
    if mutate:
        mutate(ctx)
    return "ctx", [jser.parameters_to_proto(p) for p in dpf.parameters], ctx


def _set(obj, field, value):
    setattr(obj, field, value)


def _pe_level_too_large(c):
    c.previous_hierarchy_level = 0
    c.partial_evaluations_level = 1
    c.partial_evaluations.add()


def _anchor(party, mutate=None, context=False):
    """The reference corpus's fixture shape: 3 hierarchies, ld 4/6/8,
    security 44/46/48, uint32 values."""
    protos = []
    for ld in (4, 6, 8):
        p = dpf_pb2.DpfParameters()
        p.log_domain_size = ld
        p.value_type.integer.bitsize = 32
        p.security_parameter = 40 + ld
        protos.append(p)
    dpf = DistributedPointFunction.create_incremental(
        [jser.parameters_from_proto(p) for p in protos])
    key = dpf.generate_keys_incremental(11, [1, 2, 3])[party]
    if context:
        return "ctx", protos, jser.evaluation_context_to_proto(
            dpf, dpf.create_evaluation_context(key))
    kp = jser.key_to_proto(dpf, key)
    if mutate:
        mutate(kp)
    return "key", protos, kp


def _set_bits(kind, bits):
    return lambda ps: setattr(getattr(ps[0].value_type, kind), "bitsize", bits)


def _tuple_member_bad(ps):
    ps[0].value_type.tuple.elements.add().integer.bitsize = 7


def _int_mod_n_param(base, modulus):
    def mutate(ps):
        ps[0].value_type.Clear()
        ps[0].value_type.int_mod_n.base_integer.bitsize = base
        ps[0].value_type.int_mod_n.modulus.value_uint64 = modulus
    return mutate


def _no_value_type():
    p = dpf_pb2.DpfParameters()
    p.log_domain_size = 4
    return [p]


def _integer_case_unset():
    v = dpf_pb2.Value()
    v.integer.SetInParent()
    return v


CASES = {
    # Parameters.
    "valid_one": lambda: ("create", _params(5)),
    "valid_three": lambda: ("create", _params(3, 6, 10)),
    "empty": lambda: ("parameters", []),
    "missing_value_type": lambda: ("parameters", _no_value_type()),
    "bitsize_12": lambda: ("parameters", _mutated(_set_bits("integer", 12), 4)),
    "non_ascending_equal": lambda: ("parameters", _params(6, 6)),
    "non_ascending_lower": lambda: ("parameters", _params(6, 3)),
    "domain_negative": lambda: ("parameters", _mutated(lambda ps: _set(ps[0], "log_domain_size", -1), 5)),
    "domain_too_large": lambda: ("parameters", _mutated(lambda ps: _set(ps[0], "log_domain_size", 129), 5)),
    "bitsize_zero": lambda: ("parameters", _mutated(_set_bits("integer", 0), 5)),
    "bitsize_negative": lambda: ("parameters", _mutated(_set_bits("integer", -2), 5)),
    "bitsize_too_large": lambda: ("parameters", _mutated(_set_bits("integer", 256), 5)),
    "bitsize_not_pow2": lambda: ("parameters", _mutated(_set_bits("integer", 23), 5)),
    "bitsize_unsupported_small_pow2": lambda: ("parameters", _mutated(_set_bits("integer", 4), 5)),
    "xor_bitsize_not_pow2": lambda: ("parameters", _mutated(_set_bits("xor_wrapper", 33), 5)),
    "xor_bitsize_zero": lambda: ("parameters", _mutated(_set_bits("xor_wrapper", 0), 5)),
    "tuple_member_bad_bitsize": lambda: ("parameters", _mutated(_tuple_member_bad, 5)),
    "security_nan": lambda: ("parameters", _mutated(
        lambda ps: _set(ps[0], "security_parameter", float("nan")), 4)),
    "security_negative": lambda: ("parameters", _mutated(
        lambda ps: _set(ps[0], "security_parameter", -1.0), 5)),
    "security_129": lambda: ("parameters", _mutated(
        lambda ps: _set(ps[0], "security_parameter", 129.0), 4)),
    "security_too_large": lambda: ("parameters", _mutated(
        lambda ps: _set(ps[0], "security_parameter", 160.0), 5)),
    "int_mod_n_bad_base": lambda: ("parameters", _mutated(_int_mod_n_param(9, 3), 5)),
    "int_mod_n_modulus_too_large": lambda: ("parameters", _mutated(
        _int_mod_n_param(32, 1 << 33), 5)),
    "int_mod_n_modulus_zero": lambda: ("parameters", _mutated(_int_mod_n_param(32, 0), 5)),
    "int_mod_n_valid": lambda: ("create", _mutated(_int_mod_n_param(32, 4294967291), 5)),
    "element_bitsizes_decrease": lambda: ("create", _mutated(
        lambda ps: (_set(ps[0].value_type.integer, "bitsize", 64),
                    _set(ps[1].value_type.integer, "bitsize", 32)), 5, 7)),
    "hierarchies_far_apart": lambda: ("create", _params(10, 128)),
    # Value types and values.
    "value_type_not_set": lambda: ("value_type", dpf_pb2.ValueType()),
    "value_type_tuple_valid": lambda: ("value_type", _tuple_type(
        _vt(integer=32), _int_mod_n_type(32, 4294967291), _tuple_type(_vt(xor_wrapper=8)))),
    "value_type_nested_tuple_bad": lambda: ("value_type", _tuple_type(
        _vt(integer=32), _tuple_type(_vt(xor_wrapper=12)))),
    "value_valid_32": lambda: ("value", _integer_value(23), _vt(integer=32)),
    "value_valid_128": lambda: ("value", _integer_value(1 << 100), _vt(integer=128)),
    "value_type_not_integer": lambda: ("value", _tuple_value(_value(integer=23)), _vt(integer=32)),
    "value_integer_too_large": lambda: ("value", _integer_value(1 << 32), _vt(integer=32)),
    "value_128_bit_encoding_too_large": lambda: ("value", _integer_value(1 << 70), _vt(integer=64)),
    "value_integer_case_unset": lambda: ("value", _integer_case_unset(), _vt(integer=32)),
    "value_type_not_tuple": lambda: ("value", _integer_value(23), _tuple_type(_vt(integer=32))),
    "value_tuple_size_mismatch": lambda: ("value", _tuple_value(
        _value(integer=23), _value(integer=42)), _tuple_type(_vt(integer=32))),
    "value_nested_too_large": lambda: ("value", _tuple_value(_value(integer=300)),
                                       _tuple_type(_vt(integer=8))),
    "value_tuple_valid": lambda: ("value", _tuple_value(
        _value(integer=23), _value(int_mod_n=4294967290)),
        _tuple_type(_vt(integer=32), _int_mod_n_type(32, 4294967291))),
    "value_larger_than_modulus": lambda: ("value", _value(int_mod_n=3), _int_mod_n_type(64, 3)),
    "value_int_mod_n_valid": lambda: ("value", _value(int_mod_n=2), _int_mod_n_type(64, 3)),
    "value_int_mod_n_case_mismatch": lambda: ("value", _integer_value(23),
                                              _int_mod_n_type(64, 1000)),
    "value_type_not_xor_wrapper": lambda: ("value", _integer_value(23), _vt(xor_wrapper=32)),
    "value_xor_wrapper_too_large": lambda: ("value", _value(xor_wrapper=256), _vt(xor_wrapper=8)),
    "value_xor_wrapper_valid": lambda: ("value", _value(xor_wrapper=255), _vt(xor_wrapper=8)),
    "value_type_unknown": lambda: ("value", dpf_pb2.Value(), dpf_pb2.ValueType()),
    # Keys.
    "key_valid": lambda: _key_case(),
    "key_seed_missing": lambda: _key_case(lambda k: k.ClearField("seed")),
    "key_last_level_vc_missing": lambda: _key_case(
        lambda k: k.ClearField("last_level_value_correction")),
    "key_correction_word_removed": lambda: _key_case(lambda k: k.correction_words.pop()),
    "key_correction_word_deleted": lambda: _key_case(lambda k: k.correction_words.__delitem__(-1)),
    "key_correction_word_added": lambda: _key_case(lambda k: k.correction_words.add()),
    "key_all_correction_words_cleared": lambda: _key_case(
        lambda k: k.ClearField("correction_words")),
    "key_intermediate_vc_present": lambda: _intermediate_vc(False),
    "key_intermediate_vc_missing": lambda: _intermediate_vc(True),
    # Evaluation contexts.
    "ctx_valid": lambda: _ctx_case(),
    "ctx_key_missing": lambda: _ctx_case(lambda c: c.ClearField("key")),
    "ctx_key_seed_missing": lambda: _ctx_case(lambda c: c.key.ClearField("seed")),
    "ctx_parameters_removed": lambda: _ctx_case(lambda c: c.parameters.pop()),
    "ctx_parameters_added": lambda: _ctx_case(lambda c: c.parameters.add()),
    "ctx_log_domain_size_mismatch": lambda: _ctx_case(
        lambda c: _set(c.parameters[0], "log_domain_size", 4)),
    "ctx_value_type_mismatch": lambda: _ctx_case(
        lambda c: _set(c.parameters[0].value_type.integer, "bitsize", 64)),
    "ctx_security_parameter_mismatch": lambda: _ctx_case(
        lambda c: _set(c.parameters[0], "security_parameter", 100.0)),
    "ctx_fully_evaluated": lambda: _ctx_case(lambda c: _set(c, "previous_hierarchy_level", 1)),
    "ctx_default_security_zero": lambda: _ctx_case(
        lambda c: _set(c.parameters[0], "security_parameter", 0.0)),
    "ctx_default_security_explicit": lambda: _ctx_case(
        lambda c: _set(c.parameters[0], "security_parameter", 43.0)),
    "ctx_partial_evaluations_level_too_large": lambda: _ctx_case(_pe_level_too_large),
    # The reference corpus's three-hierarchy fixture.
    "anchor_key_party0": lambda: _anchor(0),
    "anchor_key_party1": lambda: _anchor(1),
    "anchor_ctx_party0": lambda: _anchor(0, context=True),
    "anchor_ctx_party1": lambda: _anchor(1, context=True),
    "anchor_key_correction_word_added": lambda: _anchor(0, lambda k: k.correction_words.add()),
}


def _calls(op, *args):
    """(JAX call, port call) of one validation."""
    if op in ("create", "parameters"):
        (params,) = args
        name = "create" if op == "create" else "validate_parameters"
        return (lambda: getattr(JaxValidator, name)(params),
                lambda: getattr(ProtoValidator, name)(_bytes(params)))
    if op == "value_type":
        (vt,) = args
        return (lambda: JaxValidator.validate_value_type(vt),
                lambda: ProtoValidator.validate_value_type(vt.SerializeToString()))
    if op == "value":
        v, vt = args
        return (lambda: JaxValidator.validate_value(v, vt),
                lambda: ProtoValidator.validate_value(v.SerializeToString(),
                                                      vt.SerializeToString()))
    params, msg = args
    method = "validate_dpf_key" if op == "key" else "validate_evaluation_context"
    return (lambda: getattr(JaxValidator.create(params), method)(msg),
            lambda: getattr(ProtoValidator.create(_bytes(params)), method)(
                msg.SerializeToString()))


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_port_validator_agrees_with_jax(case):
    jax_call, port_call = _calls(*CASES[case]())
    try:
        jax_call()
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want)
    else:
        port_call()


def test_every_jax_rejection_has_a_case():
    """Each rejecting case raises on both sides (the agreement test would
    also pass if both accepted)."""
    accepted = [c for c in CASES if c.endswith("valid") or "valid_" in c
                or c.startswith(("anchor_key_party", "anchor_ctx", "key_intermediate_vc_present",
                                 "ctx_default_security", "element_bitsizes", "hierarchies_far"))]
    for case in CASES:
        jax_call, port_call = _calls(*CASES[case]())
        if case in accepted:
            jax_call()
            port_call()
        else:
            with pytest.raises(ValueError):
                jax_call()
            with pytest.raises(ValueError):
                port_call()
