"""A port Leader with a JAX Helper, and a JAX Leader with a port Helper.

Both packages' sessions speak the same framed wire: the proto bytes of
the port's codec and the JAX package's protobuf, wrapped in the
trace-context envelope (`observability/propagation.py`, versions 1-3).
On the CPU at 128 records of 16 B (numpy seed), each direction carries
client requests of one query over an `InProcessTransport` of its own
package and must reconstruct every record, with the envelope at v3 (the
generation echo) and pinned at v1 (`helper_digest=False`). The JAX
sessions batch one key at a time (`max_batch_size=1`), so the JAX side
compiles one XLA program for the module.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.pir import DenseDpfPirDatabase as JDatabase
from distributed_point_functions_tpu.protos import pir_pb2
from distributed_point_functions_tpu.serving import service as jservice
from distributed_point_functions_tpu.serving import transport as jtransport
from distributed_point_functions_tpu.testing import encrypt_decrypt as jed
from distributed_point_functions_tpu_torch import serialization
from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient, DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    InProcessTransport,
    LeaderSession,
    ServingConfig,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

NUM_RECORDS = 128
RECORD_BYTES = 16
QUERIES = [0, 17, 64, 127]


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(4242)
    return [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]


# Every session's requests carry a deadline, so that a stalled batch fails
# its test instead of holding the test process; the JAX sessions' covers
# their first request's compile.
TIMEOUT_MS = 10_000.0
JAX_TIMEOUT_MS = 60_000.0


@pytest.fixture(scope="module")
def jax_db(records):
    b = JDatabase.Builder()
    for r in records:
        b.insert(r)
    return b.build()


@pytest.mark.parametrize("digest", [True, False])
def test_port_leader_with_jax_helper(records, jax_db, digest):
    jhelper = jservice.HelperSession(
        jax_db, jed.decrypt, config=jservice.ServingConfig(
            max_batch_size=1, request_timeout_ms=JAX_TIMEOUT_MS))
    leader = LeaderSession(
        DenseDpfPirDatabase(records, device="cpu"),
        InProcessTransport(jhelper.handle_wire),
        config=ServingConfig(helper_digest=digest, request_timeout_ms=TIMEOUT_MS),
        device="cpu")
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with leader:
        for i in QUERIES:
            request, state = client.create_request([i])
            assert client.handle_response(leader.handle_request(request), state) == [records[i]]
        counters = leader.metrics.export()["counters"]
    jhelper.close()
    assert counters["leader.wire_downgrades"] == 0
    assert leader._peer_envelope is True
    assert leader._peer_wire_version == (3 if digest else 1)


@pytest.mark.parametrize("digest", [True, False])
def test_jax_leader_with_port_helper(records, jax_db, digest):
    helper = HelperSession(DenseDpfPirDatabase(records, device="cpu"),
                           encrypt_decrypt.decrypt,
                           ServingConfig(request_timeout_ms=TIMEOUT_MS), device="cpu")
    jleader = jservice.LeaderSession(
        jax_db, jtransport.InProcessTransport(helper.handle_wire),
        config=jservice.ServingConfig(max_batch_size=1, helper_digest=digest,
                                      request_timeout_ms=JAX_TIMEOUT_MS))
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with helper:
        for i in QUERIES:
            request, state = client.create_request([i])
            wire = serialization.serialize_pir_request(client.dpf, request)
            jrequest = jser.pir_request_from_proto(
                jleader.server.dpf, pir_pb2.PirRequest.FromString(wire))
            jresponse = jleader.handle_request(jrequest)
            response = serialization.parse_pir_response(
                jser.pir_response_to_proto(jresponse).SerializeToString())
            assert client.handle_response(response, state) == [records[i]]
        counters = jleader.metrics.export()["counters"]
    jleader.close()
    assert counters.get("leader.wire_downgrades", 0) == 0
    assert helper.metrics.export()["counters"]["helper.batcher.batches"] == len(QUERIES)
