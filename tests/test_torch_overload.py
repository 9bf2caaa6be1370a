"""The JAX package's overload contracts (`tests/test_overload.py`) on the
port: shed-early admission, QoS fairness, brownout, on the CPU.

* Under a scripted 2x over-capacity load, goodput stays at or above 70%
  of the saturation measured in the same run, and the excess is shed at
  admission with a `retry_after_s` hint and a reason, before any device
  work (no request expires in a batch).
* Backlogged tenants drain in proportion to their weights (within 15%).
* Expired requests never reach the evaluator; a bucket of only expired
  requests is not evaluated.
* The brownout ladder moves the serving knobs (admission floor, batch
  cap, the PIR tier floor) and reverts them all.
* Every response a client receives under overload equals the fault-free
  answer (the port's plain server), byte for byte.
* A Helper's shed reaches the Leader as a typed `Overloaded`; the retry
  budget stops the Leader's retry ladder; a Leader sheds before its
  Helper leg, so a shed request costs the Helper nothing; tenants reach
  admission through `handle_wire`.

The throughput-shaped tests run the real `DynamicBatcher` and
`AdmissionController` over a stub evaluator with a fixed service time a
key; the byte-identity and wire tests run `device="cpu"` sessions. Left
out, and where each waits: the mesh cases (the port's multi-device
slice) and the prober cases (`serving/prober.py`).
"""

import json
import threading
import time

import numpy as np
import pytest

from distributed_point_functions_tpu_torch import serialization
from distributed_point_functions_tpu_torch.capacity import (
    AdmissionController,
    BrownoutController,
    CapacityModel,
    TenantPolicy,
    ThroughputCalibration,
)
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
)
from distributed_point_functions_tpu_torch.pir import server as pir_server
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    HelperUnavailable,
    InProcessTransport,
    LeaderSession,
    Overloaded,
    PlainSession,
    ServingConfig,
)
from distributed_point_functions_tpu_torch.serving.batcher import DynamicBatcher
from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
from distributed_point_functions_tpu_torch.serving.transport import TransportTimeout
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

NUM_RECORDS = 128
RECORD_BYTES = 16
RNG = np.random.default_rng(99)
RECORDS = [RNG.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]
# Every session's requests carry a deadline and every thread is joined
# with a timeout, so a stalled batch fails its test.
TIMEOUT_MS = 60_000.0


def database():
    return DenseDpfPirDatabase(RECORDS, device="cpu")


def exact_model(tmp_path, qps):
    """A model whose serving q/s is the stub's service rate, through a
    history file."""
    path = tmp_path / "history.jsonl"
    path.write_text(json.dumps(
        {"metric": "serving_closed_loop_queries_per_sec", "value": qps}) + "\n")
    return CapacityModel(device_memory_bytes=16 << 30,
                         calibration=ThroughputCalibration(str(path)))


@pytest.fixture(autouse=True)
def _clear_global_tier_floor():
    yield
    pir_server.clear_tier_floor()


def _stub(keys):
    time.sleep(len(keys) * 0.001)  # 1 ms a key: 1,000 keys/s
    return list(keys)


def test_goodput_survives_2x_overload_with_early_shed(tmp_path):
    adm = AdmissionController(exact_model(tmp_path, 1000.0), queue_budget_ms=60.0,
                              metrics=MetricsRegistry())
    batcher = DynamicBatcher(_stub, max_batch_size=16, max_wait_ms=0.5,
                             max_queue=100_000, metrics=adm.metrics, admission=adm)
    keys_per_request = 8
    lock = threading.Lock()
    stats = {}

    def run_phase(num_threads, duration_s):
        stats.update(ok_keys=0, shed=0, bad_hints=0, deadline=0)
        stop = time.monotonic() + duration_s

        def worker(i):
            while time.monotonic() < stop:
                payload = [f"t{i}"] * keys_per_request
                try:
                    out = batcher.submit(payload, deadline=time.monotonic() + 0.5)
                    assert out == payload
                    with lock:
                        stats["ok_keys"] += keys_per_request
                except Overloaded as e:
                    with lock:
                        stats["shed"] += 1
                        stats["bad_hints"] += e.retry_after_s <= 0 or e.reason is None
                    time.sleep(min(e.retry_after_s, 0.05))  # honor the hint
                except Exception:  # noqa: BLE001 - counted, not raised
                    with lock:
                        stats["deadline"] += 1

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(num_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        return dict(stats)

    try:
        sat = run_phase(num_threads=6, duration_s=1.0)
        over = run_phase(num_threads=12, duration_s=1.0)
    finally:
        batcher.close()
    assert sat["ok_keys"] > 0
    assert over["ok_keys"] >= 0.70 * sat["ok_keys"], (sat, over)
    assert over["shed"] > 0 and over["bad_hints"] == 0
    counters = adm.metrics.export()["counters"]
    assert counters["batcher.requests_shed"] >= over["shed"]
    assert counters.get("batcher.expired_in_batch", 0) == 0
    shed = {k: v for k, v in counters.items() if k.startswith("admission.shed{")}
    assert sum(shed.values()) >= over["shed"]
    assert adm.outstanding_ms == pytest.approx(0.0, abs=1e-6)  # every cost released


def test_weighted_fair_shares_hold_within_15_percent(tmp_path):
    adm = AdmissionController(exact_model(tmp_path, 1000.0), queue_budget_ms=10_000.0)
    weights = {"gold": 3.0, "silver": 2.0, "bronze": 1.0}
    for tenant, w in weights.items():
        adm.set_tenant(tenant, TenantPolicy(weight=w))
    # One key a batch: completions count the queue's dequeue order.
    batcher = DynamicBatcher(_stub, max_batch_size=1, max_wait_ms=0.0,
                             max_queue=100_000, admission=adm)
    served = {t: 0 for t in weights}
    lock = threading.Lock()
    stop = time.monotonic() + 1.5

    def worker(tenant):
        while time.monotonic() < stop:
            batcher.submit([tenant], tenant=tenant)
            with lock:
                served[tenant] += 1

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in weights for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        batcher.close()
    total = sum(served.values())
    assert total > 200, served
    for tenant, w in weights.items():
        assert served[tenant] / total == pytest.approx(
            w / sum(weights.values()), rel=0.15), served


def _blocking_batcher(calls, gate):
    def evaluate(keys):
        calls.append(list(keys))
        if keys[0] == "blocker":
            gate.wait(2.0)
        return list(keys)

    return DynamicBatcher(evaluate, max_batch_size=4, max_wait_ms=1.0,
                          metrics=MetricsRegistry())


def test_expired_requests_dropped_before_dispatch():
    calls, gate = [], threading.Event()
    batcher = _blocking_batcher(calls, gate)
    doomed_err, survivor_out = [], []
    try:
        blocker = threading.Thread(target=lambda: batcher.submit(["blocker"]))
        blocker.start()
        time.sleep(0.05)  # the worker is inside evaluate()

        def doomed():
            try:
                batcher.submit(["doomed"], deadline=time.monotonic() + 0.05)
            except Exception as e:  # noqa: BLE001
                doomed_err.append(e)

        t1 = threading.Thread(target=doomed)
        t2 = threading.Thread(target=lambda: survivor_out.append(batcher.submit(["survivor"])))
        t1.start()
        t2.start()
        t1.join(1.0)
        time.sleep(0.05)
        gate.set()
        t2.join(5.0)
        blocker.join(5.0)
    finally:
        gate.set()
        batcher.close()
    assert type(doomed_err[0]).__name__ == "DeadlineExceeded"
    assert survivor_out == [["survivor"]]
    assert all("doomed" not in batch for batch in calls)
    assert batcher.metrics.export()["counters"]["batcher.expired_in_batch"] == 1


def test_all_dead_batch_skips_dispatch_entirely():
    calls, gate = [], threading.Event()
    batcher = _blocking_batcher(calls, gate)
    try:
        blocker = threading.Thread(target=lambda: batcher.submit(["blocker"]))
        blocker.start()
        time.sleep(0.05)
        t1 = threading.Thread(target=lambda: pytest.raises(
            Exception, batcher.submit, ["doomed"], deadline=time.monotonic() + 0.05))
        t1.start()
        t1.join(1.0)
        time.sleep(0.1)
        gate.set()
        blocker.join(5.0)
        deadline = time.monotonic() + 5.0
        while (batcher.metrics.export()["counters"].get("batcher.batches_skipped_dead", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        gate.set()
        batcher.close()
    assert batcher.metrics.export()["counters"]["batcher.batches_skipped_dead"] == 1
    assert calls == [["blocker"]]


def _config(**kw):
    return ServingConfig(max_batch_size=4, max_wait_ms=1.0,
                         request_timeout_ms=TIMEOUT_MS, **kw)


def test_brownout_ladder_moves_serving_knobs_and_reverts():
    breaching = [True]
    with PlainSession(database(), _config(admission_enabled=True), device="cpu") as session:
        session.set_tenant("batch", TenantPolicy(priority=0))
        ladder = session.attach_brownout(
            BrownoutController(signal=lambda: breaching[0], engage_after_s=0.0,
                               escalate_after_s=0.0, revert_after_s=0.0,
                               metrics=session.metrics),
            batch_cap=2, cheap_tier="streaming")
        adm = session.admission
        assert ladder.evaluate() == 1  # shed_low_priority
        assert adm.min_priority == 1
        client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
        request = client.create_plain_requests([7])[0]
        with pytest.raises(Overloaded) as exc_info:
            session.handle_request(request, tenant="batch")
        assert exc_info.value.reason == "priority" and exc_info.value.retry_after_s > 0
        assert ladder.evaluate() == 2  # cap_batches
        assert session.batcher.batch_cap == 2
        assert ladder.evaluate() == 3  # force_cheap_tier
        assert pir_server.tier_floor() == "streaming"
        assert ladder.evaluate() == 4  # critical_only
        assert adm.min_priority == 2
        with pytest.raises(Overloaded):
            session.handle_request(request)  # default tenant: priority 1
        breaching[0] = False
        for want in (3, 2, 1, 0):
            assert ladder.evaluate() == want
        assert adm.min_priority == 0
        assert session.batcher.batch_cap is None
        assert pir_server.tier_floor() == "materialized"
        response = session.handle_request(request, tenant="batch")
        oracle = DenseDpfPirServer.create_plain(database(), device="cpu")
        assert (response.dpf_pir_response.masked_response
                == oracle.handle_plain_request(request).dpf_pir_response.masked_response)
        counters = session.metrics.export()["counters"]
        assert counters["brownout.engaged{step=critical_only}"] == 1
        assert counters["brownout.reverted{step=shed_low_priority}"] == 1


def test_overloaded_session_responses_bit_identical_to_oracle():
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    indices = [3, 17, 42, 77, 99, 101, 5, 64]
    requests = {i: client.create_plain_requests([i])[0] for i in indices}
    oracle_server = DenseDpfPirServer.create_plain(database(), device="cpu")
    oracle = {i: oracle_server.handle_plain_request(requests[i]).dpf_pir_response
              .masked_response for i in indices}
    results, errors, lock = {}, [], threading.Lock()
    with PlainSession(database(), _config(admission_enabled=True), device="cpu") as session:
        # A tight quota sheds mid-run; clients retry on the hint.
        session.set_tenant("bursty", TenantPolicy(rate_qps=30.0, burst=2.0))

        def worker(slot, index):
            tenant = "bursty" if slot % 2 == 0 else "default"
            for _ in range(400):
                try:
                    response = session.handle_request(requests[index], tenant=tenant)
                    with lock:
                        results[(slot, index)] = response.dpf_pir_response.masked_response
                    return
                except Overloaded as e:
                    time.sleep(max(e.retry_after_s, 1e-3))
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(e)
                    return
            with lock:
                errors.append(RuntimeError(f"slot {slot} never served"))

        threads = [threading.Thread(target=worker, args=(slot, index))
                   for slot, index in enumerate(indices * 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        counters = session.metrics.export()["counters"]
    assert not errors, errors
    assert len(results) == len(indices) * 2
    for (_slot, index), masked in results.items():
        assert masked == oracle[index], f"index {index} corrupted"
    assert counters.get("plain.admission.shed{reason=quota}", 0) > 0


def test_helper_shed_travels_to_leader_as_typed_overloaded():
    helper = HelperSession(database(), encrypt_decrypt.decrypt,
                           _config(admission_enabled=True), device="cpu")
    # One token, near-zero refill: the second request is shed over the wire.
    helper.admission.set_tenant("default", TenantPolicy(rate_qps=0.01, burst=1.0))
    leader_config = _config(helper_retries=2, helper_backoff_ms=1.0,
                            helper_backoff_max_ms=2.0)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with LeaderSession(database(), InProcessTransport(helper.handle_wire), leader_config,
                       device="cpu") as leader:
        request, state = client.create_request([11])
        assert client.handle_response(leader.handle_request(request), state) == [RECORDS[11]]
        second, _ = client.create_request([23])
        with pytest.raises(Overloaded) as exc_info:
            leader.handle_request(second)
        assert exc_info.value.reason == "helper_overloaded"
        assert exc_info.value.retry_after_s > 0
        counters = leader.metrics.export()["counters"]
        assert counters["leader.helper_overloaded"] == 1
        assert counters.get("leader.helper_retries", 0) == 0
        assert leader.breaker.state == "closed"
    helper_counters = helper.metrics.export()["counters"]
    assert helper_counters["helper.wire_overloads"] == 1
    assert helper_counters["helper.admission.shed{reason=quota}"] == 1
    helper.close()


class DeadTransport:
    """Every round trip times out."""

    def __init__(self):
        self.attempts = 0

    def roundtrip(self, data, timeout=None, on_sent=None):
        self.attempts += 1
        if on_sent is not None:
            on_sent()
        raise TransportTimeout("dead transport")

    def close(self):
        pass


def test_retry_budget_exhaustion_stops_the_ladder():
    transport = DeadTransport()
    config = _config(helper_retries=50, helper_backoff_ms=0.1, helper_backoff_max_ms=0.2,
                     helper_retry_budget_min=3.0, breaker_enabled=False)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with LeaderSession(database(), transport, config, device="cpu") as leader:
        assert leader.breaker is None and leader.breaker_export() is None
        request, _ = client.create_request([9])
        with pytest.raises(HelperUnavailable, match="retry budget exhausted"):
            leader.handle_request(request)
        export = leader.metrics.export()
    assert transport.attempts == 4  # 1 attempt + 3 budgeted retries
    assert export["counters"]["leader.retries_budget_exhausted"] == 1
    assert export["counters"]["leader.helper_retries"] == 3
    assert export["gauges"]["leader.retry_budget_tokens"] == 0.0


def test_leader_sheds_before_the_helper_leg_and_releases_every_cost(tmp_path):
    helper = HelperSession(database(), encrypt_decrypt.decrypt, _config(), device="cpu")
    calls = []

    def helper_wire(data):
        calls.append(len(data))
        return helper.handle_wire(data)

    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with LeaderSession(database(), InProcessTransport(helper_wire),
                       _config(admission_enabled=True), device="cpu") as leader:
        leader.set_tenant("gold", TenantPolicy(weight=3.0, rate_qps=1000.0, burst=4.0))
        leader.set_tenant("capped", TenantPolicy(rate_qps=0.01, burst=1.0))
        request, state = client.create_request([5])
        wire = leader.handle_wire(
            serialization.serialize_pir_request(client.dpf, request), tenant="gold")
        assert wire and calls
        assert client.handle_response(leader.handle_request(request, tenant="capped"),
                                      state) == [RECORDS[5]]
        sent = len(calls)
        with pytest.raises(Overloaded) as exc_info:
            leader.handle_request(request, tenant="capped")
        assert exc_info.value.reason == "quota" and exc_info.value.retry_after_s > 0
        assert len(calls) == sent  # the shed request never reached the Helper
        tenants = leader.admission.export()["tenants"]
        assert tenants["gold"]["admitted"] == 1 and tenants["capped"]["shed"] == 1
        assert leader.admission.outstanding_ms == pytest.approx(0.0, abs=1e-9)
    helper.close()


def test_sessions_report_utilization_and_workload():
    from distributed_point_functions_tpu_torch.observability.utilization import (
        UtilizationTracker,
    )
    from distributed_point_functions_tpu_torch.observability.workload import (
        WorkloadObservatory,
    )

    tracker = UtilizationTracker(window_s=0.05)
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    helper = HelperSession(database(), encrypt_decrypt.decrypt, _config(), device="cpu")
    with LeaderSession(database(), InProcessTransport(helper.handle_wire), _config(),
                       device="cpu") as leader:
        leader.set_utilization(tracker)
        observatory = leader.attach_workload(WorkloadObservatory())
        for i in (1, 2, 3):
            request, state = client.create_request([i])
            assert client.handle_response(leader.handle_request(request), state) == [RECORDS[i]]
        export = tracker.export()
        assert export["totals"]["busy_s"] > 0
        assert set(export["threads"]) >= {"worker", "leader"}
        assert "helper_rtt" in export["totals"]["idle_s"]
        assert observatory.export()["observations"] == 3
        assert leader.capacity_accuracy.export()["ledger"]["cells"]
    helper.close()


@pytest.mark.parametrize("switch", [{"batching": False}, {"pipeline_depth": 1},
                                    {"utilization": False}])
def test_session_switches_serve_the_same_bytes(switch):
    """Each of `ServingConfig`'s switches serves the default config's
    bytes: no batcher (each request its own evaluation), completion on the
    worker, no utilization accounting."""
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    request = client.create_plain_requests([3, 77])[0]
    with PlainSession(database(), _config(), device="cpu") as base, \
            PlainSession(database(), _config(**switch), device="cpu") as session:
        want = base.handle_request(request).dpf_pir_response.masked_response
        assert session.handle_request(request).dpf_pir_response.masked_response == want
        assert (session.batcher is None) == ("batching" in switch)
        assert (session._util is None) == ("utilization" in switch)
        assert base._util is not None


def test_wire_sheds_before_decoding_and_tops_up_multi_key_requests():
    """With admission, `handle_wire` admits one key before it decodes, so
    an over-quota or below-floor tenant's request is refused without a
    decode (here: bytes that would not decode); a request of more keys is
    topped up to its count once decoded, and every cost goes back."""
    from distributed_point_functions_tpu_torch.observability import propagation

    helper = HelperSession(database(), encrypt_decrypt.decrypt, _config(), device="cpu")
    client = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt)
    with LeaderSession(database(), InProcessTransport(helper.handle_wire),
                       _config(admission_enabled=True), device="cpu") as leader:
        leader.set_tenant("capped", TenantPolicy(rate_qps=0.01, burst=3.0))
        leader.set_tenant("batch", TenantPolicy(priority=0))
        request, state = client.create_request([4, 9])  # two keys: tops up to 2
        reply = leader.handle_wire(propagation.encode_request(
            "00000000000000aa", serialization.serialize_pir_request(client.dpf, request),
            version=1), "capped")
        _, inner = propagation.try_decode_response(reply)
        assert client.handle_response(serialization.parse_pir_response(inner),
                                      state) == [RECORDS[4], RECORDS[9]]
        leader.admission.set_min_priority(1)
        for tenant, reason in (("capped", "quota"), ("batch", "priority")):
            # 1 token left < 2 keys is a quota shed only once decoded; an
            # empty bucket or the floor sheds before.
            if tenant == "capped":
                leader.admission.admit(1, tenant="capped")
            with pytest.raises(propagation.WireErrorResponse) as err:
                propagation.try_decode_response(leader.handle_wire(
                    propagation.encode_request("00000000000000bb", b"\xff\xff", version=1),
                    tenant))
            assert f"({reason})" in str(err.value) and err.value.retry_after_s > 0
        assert leader.admission.export()["tenants"]["capped"]["admitted"] == 3
    helper.close()
