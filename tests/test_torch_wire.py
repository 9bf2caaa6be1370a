"""The port's proto3 wire format against the JAX package's protobuf bytes.

`distributed_point_functions_tpu_torch.serialization` writes the dense
path's messages without `protobuf`; every message here must serialize to
exactly the bytes of the JAX package's `*_to_proto(...).SerializeToString()`
for the same fields, and each package must parse the other's bytes back
to equal fields. The keys are random and include what proto3 leaves out or
keeps by presence: zero seeds and values, party 0 and 1, all-false
controls, 128-bit and 64-bit values, negative and large numbers. Host
code only: the JAX side runs protobuf, no XLA program.
"""

import dataclasses
import struct

import numpy as np
import pytest

from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.dpf import CorrectionWord as JCw
from distributed_point_functions_tpu.dpf import DistributedPointFunction as JDpf
from distributed_point_functions_tpu.dpf import DpfKey as JKey
from distributed_point_functions_tpu.dpf import DpfParameters as JParams
from distributed_point_functions_tpu.pir import messages as jmessages
from distributed_point_functions_tpu.protos import dpf_pb2, pir_pb2
from distributed_point_functions_tpu.value_types import IntType as JInt
from distributed_point_functions_tpu.value_types import XorType as JXor
from distributed_point_functions_tpu_torch import serialization as ser
from distributed_point_functions_tpu_torch.dpf import (
    CorrectionWord,
    DistributedPointFunction,
    DpfKey,
    DpfParameters,
)
from distributed_point_functions_tpu_torch.pir import messages
from distributed_point_functions_tpu_torch.value_types import IntType, XorType

U128 = (1 << 128) - 1


def _jvt(vt):
    return JInt(vt.bits) if isinstance(vt, IntType) else JXor(vt.bits)


def _pair(params):
    """(port DPF, JAX DPF) over the same hierarchy (host-side only)."""
    return (DistributedPointFunction.create_incremental(params, device="cpu"),
            JDpf.create_incremental([JParams(p.log_domain_size, _jvt(p.value_type),
                                             p.security_parameter) for p in params]))


def _to_jax(key):
    return JKey(
        seed=key.seed, party=key.party,
        correction_words=[JCw(cw.seed, cw.control_left, cw.control_right,
                              None if cw.value_correction is None
                              else list(cw.value_correction))
                          for cw in key.correction_words],
        last_level_value_correction=list(key.last_level_value_correction))


def _from_jax(key):
    return DpfKey(
        seed=key.seed, party=key.party,
        correction_words=[CorrectionWord(cw.seed, cw.control_left, cw.control_right,
                                         cw.value_correction)
                          for cw in key.correction_words],
        last_level_value_correction=list(key.last_level_value_correction))


def _fields(key):
    return dataclasses.asdict(key)


def _rand_u128(rng, zero_share):
    """A random 128-bit value; 0 in `zero_share` of draws, and now and then
    one with only its high or low 64 bits set."""
    r = rng.random()
    if r < zero_share:
        return 0
    v = int.from_bytes(rng.bytes(16), "little")
    if r > 0.9:
        return v & ((1 << 64) - 1)
    if r > 0.8:
        return v & ~((1 << 64) - 1)
    return v


def _random_dense_keys(rng, dpf, n, zero_share=0.3):
    levels = dpf._tree_levels_needed - 1
    keys = []
    for i in range(n):
        all_false = i % 3 == 0
        cws = [CorrectionWord(_rand_u128(rng, zero_share),
                              False if all_false else bool(rng.integers(2)),
                              False if all_false else bool(rng.integers(2)))
               for _ in range(levels)]
        keys.append(DpfKey(_rand_u128(rng, zero_share), int(rng.integers(2)), cws,
                           [_rand_u128(rng, zero_share)]))
    return keys


DENSE = [DpfParameters(lds, XorType(128)) for lds in (1, 7, 13)]


@pytest.mark.parametrize("params", DENSE, ids=lambda p: f"lds{p.log_domain_size}")
def test_dense_keys_serialize_to_jax_bytes(params):
    rng = np.random.default_rng(params.log_domain_size)
    dpf, jdpf = _pair([params])
    keys = _random_dense_keys(rng, dpf, 24)
    keys[0] = DpfKey(0, 0, [CorrectionWord(0, False, False)
                            for _ in keys[0].correction_words], [0])
    for key in keys:
        want = jser.key_to_proto(jdpf, _to_jax(key)).SerializeToString()
        got = ser.serialize_key(dpf, key)
        assert got == want
        assert _fields(ser.parse_key(dpf, want)) == _fields(key)
        back = jser.key_from_proto(jdpf, dpf_pb2.DpfKey.FromString(got))
        assert _fields(_from_jax(back)) == _fields(key)


def test_incremental_int_keys_with_value_corrections():
    """Keys of a three-level IntType(64)/XorType(32) hierarchy carry value
    corrections at inner tree levels (`Value.Integer.value_uint64`, written
    even at 0)."""
    params = [DpfParameters(3, IntType(64)), DpfParameters(6, XorType(32)),
              DpfParameters(9, IntType(64))]
    dpf, jdpf = _pair(params)
    rng = np.random.default_rng(5)
    for alpha, betas in ((0, [0, 0, 0]), (511, [(1 << 64) - 1, 7, 1 << 63]),
                         (int(rng.integers(512)), [3, 0, 12345])):
        for key in dpf.generate_keys_incremental(alpha, betas):
            assert any(cw.value_correction for cw in key.correction_words)
            want = jser.key_to_proto(jdpf, _to_jax(key)).SerializeToString()
            assert ser.serialize_key(dpf, key) == want
            assert _fields(ser.parse_key(dpf, want)) == _fields(key)
    # The same structure with every seed and value 0.
    zero = DpfKey(0, 1, [CorrectionWord(0, False, False, None if cw.value_correction is None
                                        else [0] * len(cw.value_correction))
                         for cw in key.correction_words], [0])
    want = jser.key_to_proto(jdpf, _to_jax(zero)).SerializeToString()
    assert ser.serialize_key(dpf, zero) == want


@pytest.mark.parametrize("vt,values", [
    (XorType(128), [0, 1, U128, 1 << 64, (1 << 64) - 1]),
    (IntType(64), [0, 1, (1 << 64) - 1, 1 << 63]),
    (IntType(8), [0, 255]),
    (XorType(32), [0, (1 << 32) - 1]),
])
def test_values_and_value_types(vt, values):
    jvt = _jvt(vt)
    assert ser.serialize_value_type(vt) == jser.value_type_to_proto(jvt).SerializeToString()
    assert ser.parse_value_type(ser.serialize_value_type(vt)) == vt
    for v in values:
        want = jser.value_to_proto(jvt, v).SerializeToString()
        assert ser.serialize_value(vt, v) == want
        assert ser.parse_value(vt, want) == v


@pytest.mark.parametrize("params", [
    DpfParameters(20, XorType(128)), DpfParameters(0, IntType(64)),
    DpfParameters(64, IntType(8), 0.0), DpfParameters(13, XorType(128), 57.5),
    DpfParameters(5, IntType(32), -0.0), DpfParameters(-3, IntType(64), 1e300),
])
def test_parameters(params):
    jp = JParams(params.log_domain_size, _jvt(params.value_type),
                 params.security_parameter)
    want = jser.parameters_to_proto(jp).SerializeToString()
    assert ser.serialize_parameters(params) == want
    got = ser.parse_parameters(want)
    assert (got.log_domain_size, got.value_type) == (params.log_domain_size,
                                                      params.value_type)
    assert struct.pack("<d", got.security_parameter) == struct.pack(
        "<d", params.security_parameter)


def test_blocks():
    for x in (0, 1, U128, 1 << 64, (1 << 64) - 1, 0xDEADBEEF << 70):
        want = jser.block_to_proto(x).SerializeToString()
        assert ser.serialize_block(x) == want
        assert ser.parse_block(want) == x


def _requests(keys, ciphertext):
    """Each PirRequest kind, in both packages."""
    jkeys = [_to_jax(k) for k in keys]
    return [
        (messages.PirRequest(plain_request=messages.PlainRequest(keys)),
         jmessages.PirRequest(plain_request=jmessages.PlainRequest(jkeys))),
        (messages.PirRequest(leader_request=messages.LeaderRequest(
            messages.PlainRequest(keys), messages.EncryptedHelperRequest(ciphertext))),
         jmessages.PirRequest(leader_request=jmessages.LeaderRequest(
             jmessages.PlainRequest(jkeys), jmessages.EncryptedHelperRequest(ciphertext)))),
        (messages.PirRequest(encrypted_helper_request=messages.EncryptedHelperRequest(
            ciphertext)),
         jmessages.PirRequest(encrypted_helper_request=jmessages.EncryptedHelperRequest(
             ciphertext))),
    ]


def _request_fields(req):
    return dataclasses.asdict(req)


@pytest.mark.parametrize("num_keys", [0, 1, 9])
@pytest.mark.parametrize("ciphertext", [b"", b"\x00", bytes(range(256)) * 3])
def test_pir_requests(num_keys, ciphertext):
    dpf, jdpf = _pair([DpfParameters(10, XorType(128))])
    keys = _random_dense_keys(np.random.default_rng(num_keys), dpf, num_keys)
    for ours, theirs in _requests(keys, ciphertext):
        want = jser.pir_request_to_proto(jdpf, theirs).SerializeToString()
        got = ser.serialize_pir_request(dpf, ours)
        assert got == want
        if not want:  # a plain request without keys is all defaults
            with pytest.raises(ValueError, match="no request set"):
                ser.parse_pir_request(dpf, want)
            continue
        assert _request_fields(ser.parse_pir_request(dpf, want)) == _request_fields(ours)
        back = jser.pir_request_from_proto(jdpf, pir_pb2.PirRequest.FromString(got))
        assert _request_fields(back) == _request_fields(theirs)


@pytest.mark.parametrize("num_keys", [0, 1, 9])
@pytest.mark.parametrize("seed", [b"", bytes(16), bytes(range(16))])
def test_helper_requests(num_keys, seed):
    dpf, jdpf = _pair([DpfParameters(10, XorType(128))])
    keys = _random_dense_keys(np.random.default_rng(7 + num_keys), dpf, num_keys)
    ours = messages.HelperRequest(messages.PlainRequest(keys), seed)
    theirs = jmessages.HelperRequest(
        jmessages.PlainRequest([_to_jax(k) for k in keys]), seed)
    want = jmessages.serialize_helper_request(jdpf, theirs)
    got = messages.serialize_helper_request(dpf, ours)
    assert got == want == jser.helper_request_to_proto(jdpf, theirs).SerializeToString()
    if not want:
        for parse in (messages.parse_helper_request,
                      lambda d, b: jmessages.parse_helper_request(d, b)):
            with pytest.raises(ValueError):
                parse(dpf if parse is messages.parse_helper_request else jdpf, want)
        return
    assert _request_fields(messages.parse_helper_request(dpf, want)) == _request_fields(ours)
    back = jmessages.parse_helper_request(jdpf, got)
    assert _request_fields(back) == _request_fields(theirs)


@pytest.mark.parametrize("responses", [
    [], [b""], [b"", b"\x00" * 33, bytes(range(256))], [bytes([i]) * 300 for i in range(5)]])
def test_pir_responses(responses):
    ours = messages.PirResponse(messages.DpfPirResponse(list(responses)))
    theirs = jmessages.PirResponse(jmessages.DpfPirResponse(list(responses)))
    want = jser.pir_response_to_proto(theirs).SerializeToString()
    got = ser.serialize_pir_response(ours)
    assert got == want
    assert ser.parse_pir_response(want).dpf_pir_response.masked_response == responses
    assert jser.pir_response_from_proto(
        pir_pb2.PirResponse.FromString(got)).dpf_pir_response.masked_response == responses


def _tag(field, wire_type):
    return ser._varint(field << 3 | wire_type)


def _unknown_fields():
    """Bytes of unknown fields of every wire type: varint, fixed64,
    length-delimited, a group with a field inside, fixed32."""
    return (_tag(15, 0) + b"\xff\xff\x03"
            + _tag(16, 1) + bytes(range(8))
            + _tag(17, 2) + b"\x03abc"
            + _tag(18, 3) + _tag(1, 0) + b"\x05" + _tag(18, 4)
            + _tag(19, 5) + b"\x01\x02\x03\x04")


def test_parsers_skip_unknown_fields():
    dpf, jdpf = _pair([DpfParameters(8, XorType(128))])
    keys = _random_dense_keys(np.random.default_rng(3), dpf, 3, zero_share=0.0)
    junk = _unknown_fields()
    key_bytes = ser.serialize_key(dpf, keys[0])
    assert _fields(ser.parse_key(dpf, junk + key_bytes + junk)) == _fields(keys[0])
    # protobuf parses the same bytes to the same key.
    assert _fields(_from_jax(jser.key_from_proto(
        jdpf, dpf_pb2.DpfKey.FromString(junk + key_bytes + junk)))) == _fields(keys[0])
    hr = messages.HelperRequest(messages.PlainRequest(keys), bytes(range(16)))
    data = messages.serialize_helper_request(dpf, hr) + junk
    assert _request_fields(messages.parse_helper_request(dpf, data)) == _request_fields(hr)
    assert _request_fields(jmessages.parse_helper_request(jdpf, data)) == _request_fields(
        jmessages.HelperRequest(jmessages.PlainRequest([_to_jax(k) for k in keys]),
                                bytes(range(16))))
    resp = junk + ser.serialize_pir_response(
        messages.PirResponse(messages.DpfPirResponse([b"ab", b"cd"])))
    assert ser.parse_pir_response(resp).dpf_pir_response.masked_response == [b"ab", b"cd"]


def test_parser_merges_and_takes_the_last_occurrence():
    """A singular submessage sent twice merges; a scalar sent twice takes
    the last; the oneof takes the member set last (protobuf's rules)."""
    dpf, jdpf = _pair([DpfParameters(4, XorType(128))])
    key = _random_dense_keys(np.random.default_rng(11), dpf, 1, zero_share=0.0)[0]
    data = ser.serialize_key(dpf, key)
    extra = bytes([1 << 3 | 2, 2, 2 << 3 | 0, 9]) + bytes([3 << 3 | 0, 0])
    got = ser.parse_key(dpf, data + extra)
    want = jser.key_from_proto(jdpf, dpf_pb2.DpfKey.FromString(data + extra))
    assert _fields(got) == _fields(_from_jax(want))
    assert got.seed == (key.seed & ~((1 << 64) - 1)) | 9 and got.party == 0
    plain = ser.serialize_pir_request(
        dpf, messages.PirRequest(plain_request=messages.PlainRequest([key])))
    enc = ser.serialize_pir_request(dpf, messages.PirRequest(
        encrypted_helper_request=messages.EncryptedHelperRequest(b"xyz")))
    for data in (plain + enc, enc + plain):
        got = ser.parse_pir_request(dpf, data)
        want = jser.pir_request_from_proto(jdpf, pir_pb2.PirRequest.FromString(data))
        assert (got.plain_request is None) == (want.plain_request is None)
        assert (got.encrypted_helper_request is None) == (
            want.encrypted_helper_request is None)


@pytest.mark.parametrize("data", [
    b"\x0a", b"\x0a\x05abc", b"\x08", b"\x08\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01",
    b"\x0e", b"\x00\x01", b"\x19\x00", b"\x1b\x08\x01",
])
def test_parsers_reject_malformed_bytes(data):
    dpf, _ = _pair([DpfParameters(4, XorType(128))])
    with pytest.raises(ValueError):
        ser.parse_key(dpf, data)
    with pytest.raises(Exception):
        dpf_pb2.DpfKey.FromString(data)
