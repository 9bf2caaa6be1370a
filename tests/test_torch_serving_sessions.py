"""The port's serving sessions against the JAX package's unbatched servers.

On the CPU at 128 records of 16 B (numpy seed): a `PlainSession`, and a
`LeaderSession` over an in-process transport to a `HelperSession`, each
answer 8 concurrent threads of one query a request through their
batchers; every response must be byte-equal to the JAX package's
unbatched `DenseDpfPirServer` on the same request bytes (its plain
server, its Helper's masked bytes, its Leader's combined bytes). The
JAX side runs one XLA program (one key a request), compiled once for
the module. Then the session mechanics: deadlines, the Helper leg's
retries, the breaker opening on an armed `service.helper_leg`
failpoint and closing on its half-open probe, degraded mode, and an
evaluation that raises reaching the caller as that exception. The
tolerance is bit-exact equality throughout.
"""

import threading
import time

import numpy as np
import pytest

from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.pir import DenseDpfPirDatabase as JDatabase
from distributed_point_functions_tpu.pir import DenseDpfPirServer as JServer
from distributed_point_functions_tpu.protos import pir_pb2
from distributed_point_functions_tpu.testing import encrypt_decrypt as jed
from distributed_point_functions_tpu_torch import serialization
from distributed_point_functions_tpu_torch.observability import propagation
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    messages,
)
from distributed_point_functions_tpu_torch.robustness import failpoints
from distributed_point_functions_tpu_torch.serving import (
    DeadlineExceeded,
    DynamicBatcher,
    HelperSession,
    HelperUnavailable,
    InProcessTransport,
    LeaderSession,
    Overloaded,
    PlainSession,
    ServingConfig,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

NUM_RECORDS = 128
RECORD_BYTES = 16
THREADS = 8
# Every session here gives its requests a deadline, so that a stalled
# batch fails its test instead of holding the test process.
TIMEOUT_MS = 10_000.0


def _config(**fields):
    return ServingConfig(request_timeout_ms=TIMEOUT_MS, **fields)


def _join(threads, timeout=60.0):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "a thread never finished"


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(128)
    return [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]


@pytest.fixture(scope="module")
def jax_servers(records):
    """(plain, leader, helper) JAX servers, unbatched, one shared database."""
    b = JDatabase.Builder()
    for r in records:
        b.insert(r)
    jdb = b.build()
    helper = JServer.create_helper(jdb, jed.decrypt)

    def sender(helper_request, while_waiting):
        while_waiting()
        return helper.handle_request(helper_request)

    return JServer.create_plain(jdb), JServer.create_leader(jdb, sender), helper


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.default_failpoints().clear()


def _jax_request(jserver, request_bytes):
    return jser.pir_request_from_proto(
        jserver.dpf, pir_pb2.PirRequest.FromString(request_bytes))


def _jax_masked(jserver, request_bytes, plain=False):
    req = _jax_request(jserver, request_bytes)
    out = jserver.handle_plain_request(req) if plain else jserver.handle_request(req)
    return out.dpf_pir_response.masked_response


def _concurrently(fn, n=THREADS):
    results, errors = [None] * n, []
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    _join(threads)
    if errors:
        raise errors[0]
    return results


def _pair(records, config, transport_wrap=None):
    hdb = DenseDpfPirDatabase(records, device="cpu")
    ldb = DenseDpfPirDatabase(records, device="cpu")
    helper = HelperSession(hdb, encrypt_decrypt.decrypt, config=config, device="cpu")
    handler = helper.handle_wire if transport_wrap is None else transport_wrap(helper)
    leader = LeaderSession(ldb, InProcessTransport(handler), config=config, device="cpu")
    return leader, helper


def test_plain_session_concurrent_equals_jax(records, jax_servers):
    rng = np.random.default_rng(1)
    idx = [int(i) for i in rng.integers(0, NUM_RECORDS, THREADS)]
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    reqs = [client.create_plain_requests([i]) for i in idx]
    db = DenseDpfPirDatabase(records, device="cpu")
    with PlainSession(db, _config(max_batch_size=8, max_wait_ms=20.0),
                      device="cpu") as session:
        cuda_lib.reset_launch_counts()
        got = _concurrently(lambda t: [
            session.handle_request(r).dpf_pir_response.masked_response
            for r in reqs[t]])
        assert not any(cuda_lib.LAUNCHES.values())
        counters = session.metrics.export()["counters"]
        assert counters["plain.batcher.requests_submitted"] == 2 * THREADS
        assert counters["plain.batcher.batches"] <= 2 * THREADS
    for t, i in enumerate(idx):
        for party in (0, 1):
            wire = serialization.serialize_pir_request(client.dpf, reqs[t][party])
            assert got[t][party] == _jax_masked(jax_servers[0], wire, plain=True)
        share0, share1 = (g[0] for g in got[t])
        assert bytes(a ^ b for a, b in zip(share0, share1)) == records[i]


def test_leader_and_helper_sessions_equal_jax(records, jax_servers):
    rng = np.random.default_rng(2)
    idx = [int(i) for i in rng.integers(0, NUM_RECORDS, THREADS)]
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    seen = {}
    lock = threading.Lock()

    def recording(helper):
        def handle(payload):
            reply = helper.handle_wire(payload)
            _, inner, _, _ = propagation.try_decode_request_ext(payload)
            with lock:
                seen[inner] = propagation.try_decode_response(reply)
            return reply
        return handle

    leader, helper = _pair(records, _config(max_batch_size=8, max_wait_ms=20.0),
                           recording)
    reqs = [client.create_request([i]) for i in idx]
    with leader, helper:
        got = _concurrently(lambda t: leader.handle_request(reqs[t][0]))
    jplain, jleader, jhelper = jax_servers
    for t, i in enumerate(idx):
        request, state = reqs[t]
        assert client.handle_response(got[t], state) == [records[i]]
        wire = serialization.serialize_pir_request(client.dpf, request)
        assert got[t].dpf_pir_response.masked_response == _jax_masked(jleader, wire)
    assert len(seen) == THREADS
    for helper_wire, (meta, inner) in seen.items():
        assert meta is not None and meta.get("generation") is None
        masked = serialization.parse_pir_response(inner).dpf_pir_response.masked_response
        assert masked == _jax_masked(jhelper, helper_wire)


def test_deadline_exceeded_in_queue(records):
    db = DenseDpfPirDatabase(records, device="cpu")
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request = client.create_plain_requests([3])[0]
    with PlainSession(db, _config(), device="cpu") as session:
        failpoints.default_failpoints().arm("batcher.evaluate", action="delay",
                                            delay_ms=300.0, times=1)
        first = threading.Thread(target=session.handle_request, args=(request,),
                                 daemon=True)
        first.start()
        time.sleep(0.05)
        with pytest.raises(DeadlineExceeded):
            session.handle_request(request, deadline=time.monotonic() + 0.05)
        _join([first])
        counters = session.metrics.export()["counters"]
        assert counters["plain.batcher.requests_deadline_exceeded"] == 1
        # The session keeps serving.
        assert session.handle_request(request).dpf_pir_response.masked_response


def test_helper_leg_retries_then_succeeds(records):
    leader, helper = _pair(records, _config(helper_retries=2, helper_backoff_ms=1.0))
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request, state = client.create_request([5])
    with leader, helper:
        failpoints.default_failpoints().arm("service.helper_leg", times=2)
        assert client.handle_response(leader.handle_request(request), state) == [records[5]]
        counters = leader.metrics.export()["counters"]
        assert counters["leader.helper_retries"] == 2
        assert counters["leader.helper_timeouts"] == 2
        assert counters["leader.wire_downgrades"] == 0
        failpoints.default_failpoints().arm("service.helper_leg", times=None)
        with pytest.raises(HelperUnavailable):
            leader.handle_request(request)


def test_breaker_opens_degrades_and_closes_on_probe(records, jax_servers):
    config = _config(helper_retries=0, breaker_failure_threshold=2,
                           breaker_reset_ms=100.0, allow_degraded=True)
    leader, helper = _pair(records, config)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request, state = client.create_request([9])
    leader_wire = serialization.serialize_pir_request(
        client.dpf, messages.PirRequest(plain_request=request.leader_request.plain_request))
    own_share = _jax_masked(jax_servers[0], leader_wire, plain=True)
    with leader, helper:
        now = [0.0]  # the breaker's clock, so that load cannot open its window
        leader.breaker._clock = lambda: now[0]
        failpoints.default_failpoints().arm("service.helper_leg", times=None)
        for _ in range(3):
            degraded = leader.handle_request(request)
            assert degraded.dpf_pir_response.masked_response == own_share
        assert leader.degraded and leader.breaker.state == "open"
        counters = leader.metrics.export()["counters"]
        assert counters["leader.breaker_opens"] == 1
        assert counters["leader.breaker_fast_fails"] == 1
        assert counters["leader.degraded_responses"] == 3
        failpoints.default_failpoints().clear()
        now[0] += 0.15
        assert client.handle_response(leader.handle_request(request), state) == [records[9]]
        assert leader.breaker.state == "closed" and not leader.degraded
        assert leader.metrics.export()["counters"]["leader.degraded_exits"] == 1


class KernelFailure(RuntimeError):
    pass


def _failing(server):
    def fail(request):
        raise KernelFailure("launch failed")
    server.handle_plain_request = fail


def test_evaluation_error_reaches_the_caller(records):
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    plain_request = client.create_plain_requests([1])[0]
    db = DenseDpfPirDatabase(records, device="cpu")
    with PlainSession(db, _config(), device="cpu") as session:
        _failing(session.server)
        errors = []

        def call(_):
            try:
                session.handle_request(plain_request)
            except KernelFailure as e:
                errors.append(e)
        _concurrently(call, 4)
        assert len(errors) == 4
    # The Leader's own share failing is not a Helper failure: no
    # degraded answer, the error itself.
    leader, helper = _pair(records, _config(allow_degraded=True))
    request, _ = client.create_request([2])
    with leader, helper:
        _failing(leader.server)
        with pytest.raises(KernelFailure):
            leader.handle_request(request)
        assert not leader.degraded
    # The Helper's evaluation failing in process reaches the Leader's
    # caller as itself too.
    leader, helper = _pair(records, _config(allow_degraded=True))
    with leader, helper:
        _failing(helper.server)
        with pytest.raises(KernelFailure):
            leader.handle_request(request)


def test_batcher_coalesces_sheds_and_pads():
    gate, entered = threading.Event(), threading.Event()
    seen = []

    def evaluate(keys):
        entered.set()
        gate.wait()
        seen.append(list(keys))
        return [k * 10 for k in keys]

    def queued(n):
        deadline = time.monotonic() + 10
        while len(b._queue) != n:
            assert time.monotonic() < deadline, "requests never queued"
            time.sleep(0.001)

    with DynamicBatcher(evaluate, max_batch_size=8, max_wait_ms=1.0,
                        max_queue=5) as b:
        first = threading.Thread(target=b.submit, args=([1],), daemon=True)
        threads = []
        out = [None] * 5
        try:
            first.start()
            assert entered.wait(10)  # the worker now waits inside the first batch
            for i in range(5):  # queued one at a time, in order
                threads.append(threading.Thread(target=lambda i=i: out.__setitem__(
                    i, b.submit([i + 2])), daemon=True))
                threads[-1].start()
                queued(i + 1)
            with pytest.raises(Overloaded):
                b.submit([99])
        finally:
            gate.set()
        _join([first] + threads)
    assert out == [[(i + 2) * 10] for i in range(5)]
    # One batch of one key, then the five queued ones padded to 8 with
    # copies of the first key.
    assert seen == [[1], [2, 3, 4, 5, 6, 2, 2, 2]]
    counters = b.metrics.export()["counters"]
    assert counters["batcher.padded_keys"] == 3
    assert counters["batcher.requests_shed"] == 1
    assert counters["batcher.bucket_batches{bucket=8}"] == 1


def test_leader_and_helper_over_framed_tcp(records):
    """The deployed wiring: each session behind a `FramedTcpServer`, the
    Leader reaching the Helper through a `TcpTransportPool`, concurrent
    clients sending framed request bytes."""
    from distributed_point_functions_tpu_torch.serving import (
        FramedTcpServer,
        TcpTransportPool,
        transport,
    )

    config = _config(max_batch_size=8, max_wait_ms=5.0)
    helper = HelperSession(DenseDpfPirDatabase(records, device="cpu"),
                           encrypt_decrypt.decrypt, config=config, device="cpu")
    helper_tcp = FramedTcpServer(helper.handle_wire, host="127.0.0.1").start()
    leader = LeaderSession(DenseDpfPirDatabase(records, device="cpu"),
                           TcpTransportPool("127.0.0.1", helper_tcp.port, 4),
                           config=config, device="cpu")
    leader_tcp = FramedTcpServer(leader.handle_wire, host="127.0.0.1").start()
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    rng = np.random.default_rng(3)
    idx = [int(i) for i in rng.integers(0, NUM_RECORDS, THREADS)]
    reqs = [client.create_request([i]) for i in idx]

    def call(t):
        import socket

        with socket.create_connection(("127.0.0.1", leader_tcp.port)) as sock:
            transport.send_msg(sock, serialization.serialize_pir_request(
                client.dpf, reqs[t][0]))
            return serialization.parse_pir_response(transport.recv_msg(sock))

    try:
        got = _concurrently(call)
    finally:
        leader_tcp.stop()
        helper_tcp.stop()
        leader.close()
        helper.close()
    assert [client.handle_response(r, reqs[t][1])[0] for t, r in enumerate(got)] == [
        records[i] for i in idx]
    assert leader._transport.reconnects == 0


def test_batcher_fan_out_fault_reaches_the_request():
    """A fault while a bucket's results fan out reaches its request as
    itself, and the completion thread goes on serving the next bucket."""
    with DynamicBatcher(lambda keys: [k * 10 for k in keys], max_batch_size=4,
                        max_wait_ms=1.0) as b:
        observe, calls = b._h_latency.observe, [0]

        def faulty(value):
            calls[0] += 1
            if calls[0] == 1:
                raise KernelFailure("fan-out")
            observe(value)

        b._h_latency.observe = faulty
        with pytest.raises(KernelFailure, match="fan-out"):
            b.submit([1], deadline=time.monotonic() + TIMEOUT_MS / 1e3)
        assert b.submit([2], deadline=time.monotonic() + TIMEOUT_MS / 1e3) == [20]
