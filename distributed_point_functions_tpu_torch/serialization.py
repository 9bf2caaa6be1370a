"""The dense path's wire format: proto3 bytes without `protobuf`.

The port of the JAX package's `serialization.py` for the messages dense
PIR puts on the wire, written as a small proto3 encoder and decoder over
the reference's schemas (`protos/distributed_point_function.proto`,
`protos/private_information_retrieval.proto`): `Block`, `Value` and
`ValueType` of every value type (`IntType`, `XorType`, `IntModNType` with
its modulus as a `Value.Integer`, and `TupleType`, nested ones included),
`DpfParameters`, `DpfKey` with its `CorrectionWord`s, the
`EvaluationContext` with its partial evaluations, the four
`DpfPirRequest` messages, `PirRequest`, `PirResponse`, and the server's
`PirServerPublicParams` (empty for the dense server, the cuckoo hashing
parameters with their `HashFamilyConfig` for the sparse one,
`protos/private_information_retrieval.proto:55-60`,
`protos/hash_family_config.proto`). Each `serialize_*` gives the bytes the JAX package's
`*_to_proto(...).SerializeToString()` gives for the same object, and each
`parse_*` reads any proto3 encoding of the message.

What the encoder keeps from the JAX package's protobuf objects:

* fields go out in field-number order;
* a proto3 scalar at its default (0, false, empty bytes) is left out,
  unless it is a member of a oneof (`Value.Integer.value_uint64`), which
  has presence: 0 is written;
* a submessage is written, empty or not, wherever the JAX package touches
  it (`Block` seeds of 0, a `Value` of 0, an empty encrypted request), and
  left out where it does not (a plain request without keys);
* `int32` fields hold negative values as ten-byte varints (sign-extended
  to 64 bits), `uint64` fields the full 64 bits.

The decoder skips unknown fields of every wire type (groups included) and
fields whose wire type does not match the schema, merges repeated
occurrences of a singular submessage, takes the last occurrence of a
scalar and the last member set of a oneof, and raises `ValueError` on
truncated or malformed bytes.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .dpf import (
    CorrectionWord,
    DistributedPointFunction,
    DpfKey,
    DpfParameters,
    EvaluationContext,
    PartialEvaluations,
)
from .ops import aes
from .ops.words import to_numpy, to_tensors
from .pir import messages
from .value_types import IntModNType, IntType, TupleType, XorType

_U64 = (1 << 64) - 1

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

_ONE_BYTE = [bytes((i,)) for i in range(0x80)]


def _varint(v: int) -> bytes:
    if v < 0x80:
        return _ONE_BYTE[v]
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _int32(field: int, v: int) -> bytes:
    """A proto3 `int32` field, left out at 0; negative values are
    sign-extended to ten bytes."""
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"int32 field {field} out of range: {v}")
    return _key(field, _VARINT) + _varint(v & _U64) if v else b""


def _int64(field: int, v: int) -> bytes:
    """A proto3 `int64` field, left out at 0; negative values are
    ten-byte varints."""
    if not -(1 << 63) <= v < (1 << 63):
        raise ValueError(f"int64 field {field} out of range: {v}")
    return _key(field, _VARINT) + _varint(v & _U64) if v else b""


def _double(field: int, v: float) -> bytes:
    """A proto3 `double` field, left out when its bits are all 0 (-0.0 is
    written)."""
    raw = struct.pack("<d", v)
    return _key(field, _I64) + raw if raw != bytes(8) else b""


def _bytes(field: int, v: bytes) -> bytes:
    """A proto3 `bytes` field, left out when empty."""
    return _key(field, _LEN) + _varint(len(v)) + v if v else b""


def _message(field: int, payload: bytes) -> bytes:
    """A present submessage (or one element of a repeated field), empty or
    not."""
    return _key(field, _LEN) + _varint(len(payload)) + payload


def serialize_block(x: int) -> bytes:
    """`Block{high, low}` of a 128-bit value (the bits above 128 dropped, as
    the JAX package's masks do)."""
    hi, lo = (x >> 64) & _U64, x & _U64
    return ((b"\x08" + _varint(hi) if hi else b"")
            + (b"\x10" + _varint(lo) if lo else b""))


def _integer(value: int, bits: int) -> bytes:
    """`Value.Integer`: `value_uint64` (a oneof member, so 0 is written)
    up to 64 bits, else the `value_uint128` block."""
    if bits <= 64:
        return _key(1, _VARINT) + _varint(value & _U64)
    return _message(2, serialize_block(value))


def serialize_value_type(vt) -> bytes:
    """`ValueType`: `integer` (1), `tuple` (2) of element types,
    `int_mod_n` (3) with its base integer and modulus, `xor_wrapper` (4)."""
    if isinstance(vt, IntType):
        return _message(1, _int32(1, vt.bits))
    if isinstance(vt, XorType):
        return _message(4, _int32(1, vt.bits))
    if isinstance(vt, IntModNType):
        return _message(3, _message(1, _int32(1, vt.base_bits))
                        + _message(2, _integer(vt.modulus, vt.base_bits)))
    if isinstance(vt, TupleType):
        return _message(2, b"".join(_message(1, serialize_value_type(e))
                                    for e in vt.elements))
    raise ValueError(f"unsupported value type {vt!r}")


def serialize_value(vt, value) -> bytes:
    """`Value` of a host value: an integer in the member of its type
    (`IntModNType` values by their base integer), a tuple element by
    element."""
    if isinstance(vt, IntType):
        return _message(1, _integer(value, vt.bits))
    if isinstance(vt, XorType):
        return _message(4, _integer(value, vt.bits))
    if isinstance(vt, IntModNType):
        return _message(3, _integer(value, vt.base_bits))
    if isinstance(vt, TupleType):
        return _message(2, b"".join(_message(1, serialize_value(e, v))
                                    for e, v in zip(vt.elements, value)))
    raise ValueError(f"unsupported value type {vt!r}")


def serialize_parameters(p: DpfParameters) -> bytes:
    return (_int32(1, p.log_domain_size)
            + _message(3, serialize_value_type(p.value_type))
            + _double(4, p.security_parameter))


# The controls of a correction word: fields 2 and 3, each written if true.
_CONTROLS = {(False, False): b"", (True, False): b"\x10\x01",
             (False, True): b"\x18\x01", (True, True): b"\x10\x01\x18\x01"}


def serialize_key(dpf: DistributedPointFunction, key: DpfKey) -> bytes:
    """`DpfKey`: seed, correction words (each with its value corrections at
    the tree levels that are hierarchy levels), party, last-level value
    correction."""
    parts = [_message(1, serialize_block(key.seed))]
    for i, cw in enumerate(key.correction_words):
        seed = serialize_block(cw.seed)
        # A block is at most 22 bytes, so its length is one varint byte.
        body = (b"\x0a" + _ONE_BYTE[len(seed)] + seed
                + _CONTROLS[bool(cw.control_left), bool(cw.control_right)])
        if cw.value_correction is not None:
            vt = dpf.parameters[dpf._tree_to_hierarchy[i]].value_type
            body += b"".join(_message(5, serialize_value(vt, v))
                             for v in cw.value_correction)
        parts.append(_message(2, body))
    parts.append(_int32(3, key.party))
    last_vt = dpf.parameters[-1].value_type
    parts += [_message(5, serialize_value(last_vt, v))
              for v in key.last_level_value_correction]
    return b"".join(parts)


def serialize_evaluation_context(dpf: DistributedPointFunction,
                                 ctx: EvaluationContext) -> bytes:
    """`EvaluationContext`: the DPF's parameters, the key, both levels and
    the partial evaluations (prefix, seed, control bit) sorted by prefix;
    the seeds are read back from the device."""
    parts = [_message(1, serialize_parameters(p)) for p in dpf.parameters]
    parts.append(_message(2, serialize_key(dpf, ctx.key)))
    parts.append(_int32(3, ctx.previous_hierarchy_level))
    pe = ctx.partial_evaluations
    if pe is not None and len(pe.prefixes):
        rows = pe.rows
        seeds = aes.limbs_to_u128s(to_numpy(pe.seeds)[rows])
        control = to_numpy(pe.control)[rows]
        for prefix, seed, bit in zip(pe.prefixes, seeds, control):
            parts.append(_message(4, _message(1, serialize_block(int(prefix)))
                                  + _message(2, serialize_block(seed))
                                  + (b"\x18\x01" if bit else b"")))
    parts.append(_int32(5, ctx.partial_evaluations_level))
    return b"".join(parts)


def _plain_request(dpf, keys) -> Optional[bytes]:
    """`PlainRequest` body, or None when it carries no key (the JAX
    package never touches the submessage then)."""
    if not keys:
        return None
    return b"".join(_message(1, serialize_key(dpf, k)) for k in keys)


def _optional_message(field: int, payload: Optional[bytes]) -> bytes:
    return b"" if payload is None else _message(field, payload)


def serialize_pir_request(dpf: DistributedPointFunction,
                          request: "messages.PirRequest") -> bytes:
    """`PirRequest{dpf_pir_request}` with one of the plain, leader or
    encrypted helper requests set."""
    if request.plain_request is not None:
        inner = _optional_message(1, _plain_request(dpf, request.plain_request.dpf_keys))
    elif request.leader_request is not None:
        lr = request.leader_request
        inner = _message(2, _optional_message(1, _plain_request(
            dpf, lr.plain_request.dpf_keys)) + _message(2, _bytes(
                1, lr.encrypted_helper_request.encrypted_request)))
    elif request.encrypted_helper_request is not None:
        inner = _message(3, _bytes(
            1, request.encrypted_helper_request.encrypted_request))
    else:
        raise ValueError("PirRequest has no request set")
    return _message(1, inner) if inner else b""


def serialize_helper_request(dpf: DistributedPointFunction,
                             hr: "messages.HelperRequest") -> bytes:
    """`DpfPirRequest.HelperRequest`: the plain request and the one-time
    pad's seed."""
    return (_optional_message(1, _plain_request(dpf, hr.plain_request.dpf_keys))
            + _bytes(2, hr.one_time_pad_seed))


def serialize_pir_response(response: "messages.PirResponse") -> bytes:
    """`PirResponse{dpf_pir_response{masked_response*}}`; every response is
    written, empty or not."""
    masked = response.dpf_pir_response.masked_response
    if not masked:
        return b""
    return _message(1, b"".join(
        _key(1, _LEN) + _varint(len(r)) + bytes(r) for r in masked))


def serialize_public_params(params=None) -> bytes:
    """`PirServerPublicParams`: empty for the dense server (`params` None),
    else its `cuckoo_hashing_sparse_dpf_pir_server_params` member (1) of
    `pir.cuckoo_database.CuckooHashingParams`: `hash_family_config` (1,
    always written, as the JAX package touches it), `num_hash_functions`
    (2) and `num_buckets` (3)."""
    if params is None:
        return b""
    config = params.hash_family_config
    return _message(1, _message(1, _int32(1, config.hash_family)
                                + _bytes(2, bytes(config.seed)))
                    + _int32(2, params.num_hash_functions)
                    + _int64(3, params.num_buckets))


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

Pairs = List[Tuple[int, object]]  # (field, value) in wire order


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    for _ in range(10):
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
    raise ValueError("varint longer than 10 bytes")


def _skip_group(data: bytes, pos: int, field: int) -> int:
    """Skip a group's fields up to its end-group tag; returns the position
    after it."""
    while True:
        tag, pos = _read_varint(data, pos)
        wt = tag & 7
        if wt == _EGROUP:
            if tag >> 3 != field:
                raise ValueError("mismatched end-group tag")
            return pos
        pos = _skip(data, pos, tag >> 3, wt)


def _skip(data: bytes, pos: int, field: int, wt: int) -> int:
    if wt == _VARINT:
        return _read_varint(data, pos)[1]
    if wt == _I64:
        end = pos + 8
    elif wt == _I32:
        end = pos + 4
    elif wt == _LEN:
        n, pos = _read_varint(data, pos)
        end = pos + n
    elif wt == _SGROUP:
        return _skip_group(data, pos, field)
    else:
        raise ValueError(f"invalid wire type {wt}")
    if end > len(data):
        raise ValueError("truncated field")
    return end


def _scan(data: bytes, schema: dict) -> Pairs:
    """The fields of one message whose number and wire type are in
    `schema` ({field: wire type}), in wire order: varints as ints,
    length-delimited and fixed64 fields as bytes. Every other field is
    skipped."""
    out: Pairs = []
    pos, n = 0, len(data)
    while pos < n:
        tag = data[pos]
        if tag < 0x80:
            pos += 1
        else:
            tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if field == 0:
            raise ValueError("field number 0")
        if wt == _EGROUP:
            raise ValueError("unexpected end-group tag")
        if schema.get(field) != wt:
            pos = _skip(data, pos, field, wt)
            continue
        if wt == _VARINT:
            value, pos = _read_varint(data, pos)
        elif wt == _LEN:
            length = data[pos] if pos < n else 0x80
            if length < 0x80:
                pos += 1
            else:
                length, pos = _read_varint(data, pos)
            if pos + length > n:
                raise ValueError("truncated field")
            value, pos = data[pos:pos + length], pos + length
        else:  # _I64
            if pos + 8 > n:
                raise ValueError("truncated field")
            value, pos = data[pos:pos + 8], pos + 8
        out.append((field, value))
    return out


def _fields(data: bytes, schema: dict) -> Dict[int, list]:
    """`_scan` grouped by field: {field: its values in wire order}. A
    scalar takes its last value; a singular submessage merges its values
    (`b"".join`), as protobuf does."""
    out: Dict[int, list] = {}
    for field, value in _scan(data, schema):
        if field in out:
            out[field].append(value)
        else:
            out[field] = [value]
    return out


def _oneof(data: bytes, schema: dict) -> Tuple[Optional[int], list]:
    """(member, its values) of the oneof member set last (the schema is the
    oneof's members): setting a member clears the others, so only the
    occurrences of the last member after any other member's count."""
    member, values = None, []
    for field, value in _scan(data, schema):
        if field != member:
            member, values = field, []
        values.append(value)
    return member, values


def _as_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _as_int64(v: int) -> int:
    v &= _U64
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_block(data: bytes) -> int:
    hi = lo = 0
    pos, n = 0, len(data)
    while pos < n:
        tag = data[pos]
        if tag in (0x08, 0x10):  # high, low: one-byte varint tags
            value, pos = _read_varint(data, pos + 1)
            if tag == 0x08:
                hi = value & _U64
            else:
                lo = value & _U64
        else:
            if tag >= 0x80:
                tag, pos = _read_varint(data, pos)
            else:
                pos += 1
            if tag >> 3 == 0:
                raise ValueError("field number 0")
            if tag & 7 == _EGROUP:
                raise ValueError("unexpected end-group tag")
            pos = _skip(data, pos, tag >> 3, tag & 7)
    return (hi << 64) | lo


def _parse_integer(data: bytes) -> int:
    member, values = _oneof(data, {1: _VARINT, 2: _LEN})
    if member == 2:
        return parse_block(b"".join(values))
    return values[-1] & _U64 if values else 0


_TYPE_MEMBERS = {1: _LEN, 2: _LEN, 3: _LEN, 4: _LEN}


def _bitsize(data: Optional[bytes]) -> int:
    """The `bitsize` of a `ValueType.Integer` (0 when absent)."""
    return _as_int32(_fields(data or b"", {1: _VARINT}).get(1, [0])[-1])


def parse_value_type(data: bytes):
    member, values = _oneof(data, _TYPE_MEMBERS)
    body = b"".join(values)
    if member in (1, 4):
        return (IntType if member == 1 else XorType)(_bitsize(body))
    if member == 3:
        f = _fields(body, {1: _LEN, 2: _LEN})
        return IntModNType(base_bits=_bitsize(_sub(f, 1)),
                           modulus=_parse_integer(_sub(f, 2) or b""))
    if member == 2:
        return TupleType([parse_value_type(e)
                          for e in _fields(body, {1: _LEN}).get(1, [])])
    raise ValueError("ValueType proto has no type set")


def parse_value(vt, data: bytes):
    member, values = _oneof(data, _TYPE_MEMBERS)
    body = b"".join(values)
    # A value of another kind reads as the default of this one, as the
    # JAX package's accessor of the unset member does.
    if isinstance(vt, TupleType):
        elements = _fields(body, {1: _LEN}).get(1, []) if member == 2 else []
        return tuple(parse_value(e, x) for e, x in zip(vt.elements, elements))
    field = {IntType: 1, XorType: 4, IntModNType: 3}.get(type(vt))
    if field is None:
        raise ValueError(f"unsupported value type {vt!r}")
    return _parse_integer(body) if member == field else 0


def parse_parameters(data: bytes) -> DpfParameters:
    f = _fields(data, {1: _VARINT, 3: _LEN, 4: _I64})
    return DpfParameters(
        log_domain_size=_as_int32(f.get(1, [0])[-1]),
        value_type=parse_value_type(b"".join(f.get(3, []))),
        security_parameter=struct.unpack("<d", f.get(4, [bytes(8)])[-1])[0],
    )


_CW = {1: _LEN, 2: _VARINT, 3: _VARINT, 5: _LEN}
_KEY = {1: _LEN, 2: _LEN, 3: _VARINT, 5: _LEN}


def parse_key(dpf: DistributedPointFunction, data: bytes) -> DpfKey:
    f = _fields(data, _KEY)
    cws = []
    for i, body in enumerate(f.get(2, [])):
        c = _fields(body, _CW)
        vc = None
        if 5 in c:
            hl = dpf._tree_to_hierarchy.get(i)
            if hl is None:
                raise ValueError(
                    f"value correction present at tree level {i} which is "
                    "not an output level")
            vt = dpf.parameters[hl].value_type
            vc = [parse_value(vt, v) for v in c[5]]
        cws.append(CorrectionWord(
            seed=parse_block(b"".join(c[1])) if 1 in c else 0,
            control_left=bool(c[2][-1]) if 2 in c else False,
            control_right=bool(c[3][-1]) if 3 in c else False,
            value_correction=vc,
        ))
    last_vt = dpf.parameters[-1].value_type
    return DpfKey(
        seed=parse_block(b"".join(f[1])) if 1 in f else 0,
        party=_as_int32(f[3][-1]) if 3 in f else 0,
        correction_words=cws,
        last_level_value_correction=[parse_value(last_vt, v) for v in f.get(5, [])],
    )


_CONTEXT = {1: _LEN, 2: _LEN, 3: _VARINT, 4: _LEN, 5: _VARINT}
_PARTIAL = {1: _LEN, 2: _LEN, 3: _VARINT}


def parse_evaluation_context(data: bytes, device=None):
    """(DPF, context) from `EvaluationContext` bytes: the DPF is rebuilt
    from the parameters on `device` (None: the CUDA card), and the partial
    evaluations' seeds are staged there."""
    f = _fields(data, _CONTEXT)
    dpf = DistributedPointFunction.create_incremental(
        [parse_parameters(p) for p in f.get(1, [])], device=device)
    ctx = EvaluationContext(
        key=parse_key(dpf, _sub(f, 2) or b""),
        previous_hierarchy_level=_as_int32(f.get(3, [0])[-1]),
        partial_evaluations_level=_as_int32(f.get(5, [0])[-1]))
    partial = [_fields(pe, _PARTIAL) for pe in f.get(4, [])]
    if partial:
        # Repeated prefixes keep their last occurrence, as the JAX
        # package's dict does.
        table = {parse_block(_sub(p, 1) or b""): (parse_block(_sub(p, 2) or b""),
                                                  int(bool(p.get(3, [0])[-1])))
                 for p in partial}
        seeds, control = to_tensors(
            [aes.u128s_to_limbs([s for s, _ in table.values()]),
             np.array([c for _, c in table.values()], dtype=np.uint32)], dpf._dev())
        ctx.partial_evaluations = PartialEvaluations.build(list(table), seeds, control)
    return dpf, ctx


def _parse_plain_request(dpf, data: Optional[bytes]) -> "messages.PlainRequest":
    keys = [] if data is None else [
        parse_key(dpf, k) for k in _fields(data, {1: _LEN}).get(1, [])]
    return messages.PlainRequest(dpf_keys=keys)


def _parse_encrypted(data: bytes) -> "messages.EncryptedHelperRequest":
    return messages.EncryptedHelperRequest(
        encrypted_request=bytes(_fields(data, {1: _LEN}).get(1, [b""])[-1]))


def _sub(fields: dict, field: int) -> Optional[bytes]:
    """A singular submessage: its occurrences merged, None when absent."""
    return b"".join(fields[field]) if field in fields else None


def parse_pir_request(dpf: DistributedPointFunction, data: bytes) -> "messages.PirRequest":
    inner = _sub(_fields(data, {1: _LEN}), 1)
    member, values = _oneof(inner or b"", {1: _LEN, 2: _LEN, 3: _LEN})
    body = b"".join(values)
    if member == 1:
        return messages.PirRequest(plain_request=_parse_plain_request(dpf, body))
    if member == 2:
        f = _fields(body, {1: _LEN, 2: _LEN})
        return messages.PirRequest(leader_request=messages.LeaderRequest(
            plain_request=_parse_plain_request(dpf, _sub(f, 1)),
            encrypted_helper_request=_parse_encrypted(_sub(f, 2) or b""),
        ))
    if member == 3:
        return messages.PirRequest(encrypted_helper_request=_parse_encrypted(body))
    raise ValueError("DpfPirRequest has no request set")


def parse_helper_request(dpf: DistributedPointFunction,
                         data: bytes) -> "messages.HelperRequest":
    f = _fields(data, {1: _LEN, 2: _LEN})
    return messages.HelperRequest(
        plain_request=_parse_plain_request(dpf, _sub(f, 1)),
        one_time_pad_seed=bytes(f.get(2, [b""])[-1]),
    )


def parse_pir_response(data: bytes) -> "messages.PirResponse":
    inner = _sub(_fields(data, {1: _LEN}), 1)
    masked = [] if inner is None else [
        bytes(r) for r in _fields(inner, {1: _LEN}).get(1, [])]
    return messages.PirResponse(
        dpf_pir_response=messages.DpfPirResponse(masked_response=masked))


def parse_public_params(data: bytes):
    """`PirServerPublicParams` bytes -> `pir.cuckoo_database.CuckooHashingParams`,
    or None when no cuckoo parameters are set (the dense server's)."""
    from .hashing.hash_family_config import HashFamilyConfig
    from .pir.cuckoo_database import CuckooHashingParams

    member, values = _oneof(data, {1: _LEN})
    if member is None:
        return None
    f = _fields(b"".join(values), {1: _LEN, 2: _VARINT, 3: _VARINT})
    config = _fields(_sub(f, 1) or b"", {1: _VARINT, 2: _LEN})
    return CuckooHashingParams(
        num_buckets=_as_int64(f.get(3, [0])[-1]),
        num_hash_functions=_as_int32(f.get(2, [0])[-1]),
        hash_family_config=HashFamilyConfig(
            hash_family=_as_int32(config.get(1, [0])[-1]),
            seed=bytes(config.get(2, [b""])[-1])),
    )
