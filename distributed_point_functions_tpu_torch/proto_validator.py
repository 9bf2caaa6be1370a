"""Validation of wire messages before they reach evaluation: the port of
the JAX package's `proto_validator.py` (the reference's
`dpf/internal/proto_validator.{h,cc}`), on proto3 bytes.

It reads `DpfParameters`, `ValueType`, `Value`, `DpfKey` and
`EvaluationContext` bytes through `serialization.py`'s field scanner
(presence, oneof members and repeated counts as protobuf reports them),
never through `google.protobuf`, and applies the reference's rules with
the JAX package's error messages:

* parameters: non-empty, `log_domain_size` in [0, 128] strictly
  ascending, a value type present and valid, `security_parameter` in
  [0, 128] and not NaN;
* value types: integer bit sizes positive powers of 2 up to 128 that the
  port supports, an IntModN modulus that fits its base integer, tuples
  element by element; values of the type's kind, in range, IntModN values
  below the modulus;
* keys: a seed and a last-level value correction present, exactly
  `tree_levels_needed - 1` correction words, a value correction at every
  intermediate output level;
* contexts: parameters equal to the validator's (a security parameter of
  0 reads as its default), a valid key, not already fully evaluated, and
  `partial_evaluations_level <= previous_hierarchy_level`.
"""

from __future__ import annotations

import math
import struct
from typing import Sequence

from .dpf import DistributedPointFunction
from .serialization import (
    _CW,
    _KEY,
    _LEN,
    _TYPE_MEMBERS,
    _VARINT,
    _I64,
    _as_int32,
    _fields,
    _oneof,
    _sub,
    parse_block,
    parse_parameters,
    parse_value_type,
)

_ALLOWED_BITSIZES = (8, 16, 32, 64, 128)
_PARAMETERS = {1: _VARINT, 3: _LEN, 4: _I64}
_CONTEXT = {1: _LEN, 2: _LEN, 3: _VARINT, 4: _LEN, 5: _VARINT}
_INTEGER_MEMBERS = {1: _VARINT, 2: _LEN}
_U64 = (1 << 64) - 1


def _member(data: bytes):
    """(oneof member of a `ValueType` or `Value`, its merged body)."""
    member, values = _oneof(data, _TYPE_MEMBERS)
    return member, b"".join(values)


def _bitsize(integer_type: bytes) -> int:
    return _as_int32(_fields(integer_type, {1: _VARINT}).get(1, [0])[-1])


def _elements(tuple_body: bytes) -> list:
    return _fields(tuple_body, {1: _LEN}).get(1, [])


class ProtoValidator:
    """Validator bound to one parameter vector (`DpfParameters` bytes)."""

    def __init__(self, parameters: Sequence[bytes]):
        parameters = [bytes(p) for p in parameters]
        self.validate_parameters(parameters)
        # The DPF gives the hierarchy -> tree level mapping; it evaluates
        # nothing, so it needs no device.
        self.dpf = DistributedPointFunction.create_incremental(
            [parse_parameters(p) for p in parameters])
        self.parameters = parameters

    @classmethod
    def create(cls, parameters: Sequence[bytes]) -> "ProtoValidator":
        return cls(parameters)

    # -- messages on their own -------------------------------------------------

    @staticmethod
    def _validate_integer_type(integer_type: bytes) -> None:
        bitsize = _bitsize(integer_type)
        if bitsize < 1:
            raise ValueError("bitsize must be positive")
        if bitsize > 128:
            raise ValueError("bitsize must be less than or equal to 128")
        if bitsize & (bitsize - 1):
            raise ValueError("bitsize must be a power of 2")
        if bitsize not in _ALLOWED_BITSIZES:
            raise ValueError(f"integer bitsize must be one of {_ALLOWED_BITSIZES}")

    @staticmethod
    def _integer_value_as_int(value_integer: bytes) -> int:
        member, values = _oneof(value_integer, _INTEGER_MEMBERS)
        if member == 1:
            return values[-1] & _U64
        if member == 2:
            return parse_block(b"".join(values))
        raise ValueError("Unknown value case for Value.Integer")

    @staticmethod
    def _validate_integer_value(value_integer: bytes, integer_type: bytes) -> None:
        v = ProtoValidator._integer_value_as_int(value_integer)
        bitsize = _bitsize(integer_type)
        if bitsize < 128 and v >= 1 << bitsize:
            raise ValueError(
                f"Value (= {v}) too large for ValueType with bitsize = {bitsize}")

    @staticmethod
    def validate_value_type(value_type: bytes) -> None:
        kind, body = _member(value_type)
        if kind in (1, 4):  # integer, xor_wrapper
            ProtoValidator._validate_integer_type(body)
        elif kind == 3:  # int_mod_n
            f = _fields(body, {1: _LEN, 2: _LEN})
            base = _sub(f, 1) or b""
            ProtoValidator._validate_integer_type(base)
            ProtoValidator._validate_integer_value(_sub(f, 2) or b"", base)
            parse_value_type(value_type)  # range-checks the modulus
        elif kind == 2:  # tuple
            for e in _elements(body):
                ProtoValidator.validate_value_type(e)
        else:
            raise ValueError("ValueType must have its type set")

    @staticmethod
    def validate_value(value: bytes, value_type: bytes) -> None:
        """The value's oneof member must match the type, integers must fit
        the bit size, tuples must match element by element, IntModN values
        must be reduced."""
        kind, type_body = _member(value_type)
        member, body = _member(value)
        if kind == 1:
            if member != 1:
                raise ValueError("Expected integer value")
            ProtoValidator._validate_integer_value(body, type_body)
        elif kind == 2:
            if member != 2:
                raise ValueError("Expected tuple value")
            types, values = _elements(type_body), _elements(body)
            if len(values) != len(types):
                raise ValueError(
                    f"Expected tuple value of size {len(types)} but got size {len(values)}")
            for v, t in zip(values, types):
                ProtoValidator.validate_value(v, t)
        elif kind == 3:
            if member != 3:
                raise ValueError("Expected IntModN value")
            f = _fields(type_body, {1: _LEN, 2: _LEN})
            ProtoValidator._validate_integer_value(body, _sub(f, 1) or b"")
            v = ProtoValidator._integer_value_as_int(body)
            m = ProtoValidator._integer_value_as_int(_sub(f, 2) or b"")
            if v >= m:
                raise ValueError(f"Value (= {v}) is too large for modulus (= {m})")
        elif kind == 4:
            if member != 4:
                raise ValueError("Expected XorWrapper value")
            ProtoValidator._validate_integer_value(body, type_body)
        else:
            raise ValueError("ValidateValue: Unsupported ValueType: ")

    @staticmethod
    def validate_parameters(parameters: Sequence[bytes]) -> None:
        if not parameters:
            raise ValueError("parameters must not be empty")
        previous_lds = 0
        for i, p in enumerate(parameters):
            f = _fields(p, _PARAMETERS)
            lds = _as_int32(f.get(1, [0])[-1])
            if lds < 0:
                raise ValueError("log_domain_size must be non-negative")
            if lds > 128:
                raise ValueError("log_domain_size must be <= 128")
            if i > 0 and lds <= previous_lds:
                raise ValueError("log_domain_size fields must be in ascending order")
            previous_lds = lds
            if 3 not in f:
                raise ValueError("value_type is required")
            ProtoValidator.validate_value_type(b"".join(f[3]))
            sec = struct.unpack("<d", f.get(4, [bytes(8)])[-1])[0]
            if math.isnan(sec):
                raise ValueError("security_parameter must not be NaN")
            if sec < 0 or sec > 128:
                raise ValueError("security_parameter must be in [0, 128]")

    # -- messages against the bound parameters ----------------------------------

    def validate_dpf_key(self, key: bytes) -> None:
        f = _fields(key, _KEY)
        if 1 not in f:
            raise ValueError("key.seed must be present")
        if 5 not in f:
            raise ValueError("key.last_level_value_correction must be present")
        words = f.get(2, [])
        expected = self.dpf._tree_levels_needed - 1
        if len(words) != expected:
            raise ValueError(
                f"malformed DpfKey: expected {expected} correction words, "
                f"but got {len(words)}")
        for i, tree_level in enumerate(self.dpf._hierarchy_to_tree):
            if tree_level == self.dpf._tree_levels_needed - 1:
                continue  # stored in last_level_value_correction
            if 5 not in _fields(words[tree_level], _CW):
                raise ValueError(
                    f"malformed DpfKey: expected correction_words[{tree_level}] to "
                    f"contain the value correction of hierarchy level {i}")

    def validate_evaluation_context(self, ctx: bytes) -> None:
        f = _fields(ctx, _CONTEXT)
        params = f.get(1, [])
        if len(params) != len(self.parameters):
            raise ValueError("number of parameters in ctx doesn't match")
        for i, (a, b) in enumerate(zip(self.parameters, params)):
            pa, pb = parse_parameters(a), parse_parameters(b)
            # A security parameter of 0 stands for its default.
            sa = pa.security_parameter or (40 + pa.log_domain_size)
            sb = pb.security_parameter or (40 + pb.log_domain_size)
            if (pa.log_domain_size != pb.log_domain_size
                    or pa.value_type != pb.value_type or abs(sa - sb) > 1e-9):
                raise ValueError(f"parameter {i} in ctx doesn't match")
        if 2 not in f:
            raise ValueError("ctx.key must be present")
        self.validate_dpf_key(b"".join(f[2]))
        previous = _as_int32(f.get(3, [0])[-1])
        if previous >= len(params) - 1:
            raise ValueError("this context has already been fully evaluated")
        if f.get(4) and _as_int32(f.get(5, [0])[-1]) > previous:
            raise ValueError(
                "ctx.partial_evaluations_level must be less than or equal "
                "to ctx.previous_hierarchy_level")
