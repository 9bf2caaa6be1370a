"""The Leader/Helper deployment of the port against the JAX package's.

On the CPU at 1,000 records of 33 B: a JAX client's encrypted request,
carried over the wire (protobuf bytes in, the port's parser out), is
served by the port's Leader and Helper, and the JAX client reconstructs
every record from the port's response bytes; the port's own client works
the same flow end to end; the Helper's masked response equals the JAX
package's one-time pad XOR the port's plain share for a fixed pad seed;
and a sender that never calls `while_waiting`, or a Helper whose
responses do not match the Leader's in number or length, raises.
Host-side on the JAX side (protobuf, its native keygen, its pad); the
port serves through the plain versions of its kernels.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu import prng as jprng
from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.pir import DenseDpfPirClient as JClient
from distributed_point_functions_tpu.protos import pir_pb2
from distributed_point_functions_tpu.testing import encrypt_decrypt as jed
from distributed_point_functions_tpu_torch import prng, serialization
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
    messages,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

NUM_RECORDS = 1000
RECORD_BYTES = 33
INDICES = [0, 7, 131, 500, 999, 7]


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(1000)
    return [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]


@pytest.fixture(scope="module")
def servers(records):
    """(leader, helper, plain server, helper responses seen by the sender)."""
    db = DenseDpfPirDatabase(records, device="cpu")
    helper = DenseDpfPirServer.create_helper(db, encrypt_decrypt.decrypt, device="cpu")
    seen = []

    def sender(helper_request, while_waiting):
        while_waiting()
        response = helper.handle_request(helper_request)
        seen.append(response)
        return response

    leader = DenseDpfPirServer.create_leader(db, sender, device="cpu")
    plain = DenseDpfPirServer.create_plain(db, device="cpu")
    assert (leader.role, helper.role, plain.role) == ("leader", "helper", "plain")
    return leader, helper, plain, seen


def test_jax_client_served_by_the_port_over_the_wire(records, servers):
    leader = servers[0]
    client = JClient.create(NUM_RECORDS, jed.encrypt)
    request, state = client.create_request(INDICES)
    wire = jser.pir_request_to_proto(client.dpf, request).SerializeToString()
    ours = serialization.parse_pir_request(leader.dpf, wire)
    cuda_lib.reset_launch_counts()
    response = leader.handle_request(ours)
    assert not any(cuda_lib.LAUNCHES.values())
    back = jser.pir_response_from_proto(
        pir_pb2.PirResponse.FromString(serialization.serialize_pir_response(response)))
    assert client.handle_response(back, state) == [records[i] for i in INDICES]


def test_port_client_end_to_end(records, servers):
    leader = servers[0]
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request, state = client.create_request(INDICES)
    assert request.leader_request is not None
    assert client.handle_response(leader.handle_request(request), state) == [
        records[i] for i in INDICES]
    # The Helper's leg on its own is the JAX package's to decrypt.
    helper_bytes = jed.decrypt(
        request.leader_request.encrypted_helper_request.encrypted_request,
        b"DpfPirServer")
    assert helper_bytes == messages.serialize_helper_request(
        client.dpf, messages.parse_helper_request(client.dpf, helper_bytes))
    with pytest.raises(ValueError):
        client.create_request([NUM_RECORDS])
    with pytest.raises(ValueError):
        DenseDpfPirClient.create(NUM_RECORDS, None)


def test_helper_mask_is_the_jax_pad_over_the_plain_share(records, servers, monkeypatch):
    leader, _, plain, seen = servers
    seed = bytes(range(16))
    monkeypatch.setattr(prng, "generate_seed", lambda: seed)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request, state = client.create_request(INDICES)
    assert state.one_time_pad_seed == seed
    seen.clear()
    combined = leader.handle_request(request).dpf_pir_response.masked_response
    helper_masked = seen[0].dpf_pir_response.masked_response
    inner = messages.parse_helper_request(
        client.dpf, encrypt_decrypt.decrypt(
            request.leader_request.encrypted_helper_request.encrypted_request,
            b"DpfPirServer"))
    assert inner.one_time_pad_seed == seed
    share = plain.handle_plain_request(
        messages.PirRequest(plain_request=inner.plain_request)).dpf_pir_response.masked_response
    pad = jprng.Aes128CtrSeededPrng(seed)
    assert helper_masked == [jprng.xor_bytes(s, pad.get_random_bytes(len(s))) for s in share]
    # The Leader's share, unmasked, is the plain server's for its keys.
    leader_share = plain.handle_plain_request(messages.PirRequest(
        plain_request=request.leader_request.plain_request)).dpf_pir_response.masked_response
    assert combined == [jprng.xor_bytes(h, l) for h, l in zip(helper_masked, leader_share)]


def test_leader_rejects_misbehaving_senders(records, servers):
    _, helper, _, _ = servers
    db = helper.database
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request, _ = client.create_request([3, 4])

    def lazy(helper_request, while_waiting):
        return helper.handle_request(helper_request)  # never calls back

    with pytest.raises(RuntimeError, match="while_waiting"):
        DenseDpfPirServer.create_leader(db, lazy, device="cpu").handle_request(request)

    def response_with(masked):
        def sender(helper_request, while_waiting):
            while_waiting()
            return messages.PirResponse(messages.DpfPirResponse(masked))
        return DenseDpfPirServer.create_leader(db, sender, device="cpu")

    with pytest.raises(RuntimeError, match="number of responses"):
        response_with([b"x" * RECORD_BYTES]).handle_request(request)
    with pytest.raises(RuntimeError, match="size mismatch at index 1"):
        response_with([b"x" * RECORD_BYTES, b"x"]).handle_request(request)
    with pytest.raises(ValueError, match="LeaderRequest"):
        response_with([]).handle_request(messages.PirRequest(
            plain_request=request.leader_request.plain_request))
    with pytest.raises(ValueError, match="EncryptedHelperRequest"):
        helper.handle_request(messages.PirRequest(
            plain_request=request.leader_request.plain_request))
    with pytest.raises(ValueError, match="sender"):
        DenseDpfPirServer.create_leader(db, None, device="cpu")
