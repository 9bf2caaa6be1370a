"""The blackbox prober on the port's sessions, on the CPU.

* Every kind passes on `device="cpu"` sessions: the four dense kinds
  (each forced tier really plans that tier), `leader_e2e` through a
  Leader and its Helper, `hh_sweep`, and `sparse_kv` / `sparse_absent` on
  a sparse session, also across a snapshot rotation that re-keys the
  sparse goldens.
* A `SnapshotManager` pin holds a flip off until released, and the flip
  listeners see the applied flip (what `bind_snapshots` rides on).
* Wrong bits: one word XORed into a golden record's row of every staging
  the session serves (`chip_smoke.xor_staged_word`) turns every dense
  kind to `mismatch`, journals `prober.mismatch`, fires the failure
  listener into a `BundleManager`, and undoing it gives `recovered`.
* The control logic against the JAX package's `Prober`: both packages'
  probers run the same script over stub sessions that answer from a
  table (pass, a corrupted answer, recovery, a raising server) and must
  give the same statuses, details, journal events, counter names and
  values, exports and freshness under one fake clock, and the same
  duty-cycle sleep of the background loop.
"""

import types

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.observability.events import EventJournal as JJournal
from distributed_point_functions_tpu.serving.metrics import MetricsRegistry as JRegistry
from distributed_point_functions_tpu.serving.prober import Prober as JProber
from distributed_point_functions_tpu_torch.heavy_hitters import HeavyHittersConfig
from distributed_point_functions_tpu_torch.observability.bundle import BundleManager
from distributed_point_functions_tpu_torch.observability.events import EventJournal
from distributed_point_functions_tpu_torch.pir import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingSparseDpfPirServer,
    DenseDpfPirDatabase,
)
from distributed_point_functions_tpu_torch.pir import server as server_mod
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    InProcessTransport,
    LeaderSession,
    PlainSession,
    ServingConfig,
    SnapshotManager,
    SparsePlainSession,
)
from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
from distributed_point_functions_tpu_torch.serving.prober import Prober
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

import chip_smoke

NUM_RECORDS = 300
RECORD_BYTES = 8
_RNG = np.random.default_rng(99)
RECORDS = [_RNG.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]
CONFIG = ServingConfig(max_batch_size=4, max_wait_ms=2.0, request_timeout_ms=60_000.0)
HH = dict(hh_values=[3, 3, 3, 9, 9, 14],
          hh_config=HeavyHittersConfig(domain_bits=4, level_bits=2, threshold=2))
DENSE_KINDS = ["pir_materialized", "pir_streaming", "pir_chunked", "pir_unbatched"]


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def _prober(session, records=RECORDS, **kwargs):
    kwargs.setdefault("journal", EventJournal())
    kwargs.setdefault("metrics", MetricsRegistry())
    return Prober(session, records, **kwargs)


@pytest.fixture(scope="module")
def two_party():
    helper = HelperSession(DenseDpfPirDatabase(RECORDS, device="cpu"),
                           encrypt_decrypt.decrypt, CONFIG, device="cpu")
    leader = LeaderSession(DenseDpfPirDatabase(RECORDS, device="cpu"),
                           InProcessTransport(helper.handle_wire), CONFIG, device="cpu")
    yield leader, helper
    leader.close()
    helper.close()


def test_every_kind_passes_on_the_cpu(two_party):
    leader, _ = two_party
    prober = _prober(leader, encrypter=encrypt_decrypt.encrypt, **HH)
    assert prober.kinds() == DENSE_KINDS + ["leader_e2e", "hh_sweep"]
    for _ in range(2):  # the sweep servers reset between cycles
        results = prober.run_cycle()
        assert [(r["kind"], r["status"]) for r in results] == [
            (k, "pass") for k in prober.kinds()], results
    assert server_mod.tier_floor() == "materialized"
    assert results[4]["critical_path"] is not None  # the e2e probe's helper-leg split
    counters = prober._metrics.export()["counters"]
    assert counters["prober.probes"] == 12
    assert counters["prober.passes{kind=leader_e2e}"] == 2
    # Each forced floor really plans its tier at the probe's batch.
    for tier in ("streaming", "chunked"):
        server_mod.set_tier_floor(tier)
        try:
            assert leader.server._plan_serving(3).mode == tier
        finally:
            server_mod.clear_tier_floor()
    assert leader.server._plan_serving(3).mode == "materialized"


def _sparse_db(params, records, prev=None):
    builder = CuckooHashedDpfPirDatabase.Builder()
    if prev is None:
        builder.set_params(params)
    for kv in records.items():
        builder.insert(kv)
    return builder.build(device="cpu") if prev is None else builder.build_from(prev)


def test_sparse_kinds_pass_across_a_rotation():
    rng = np.random.default_rng(1616)
    records = {b"key%d" % i: rng.bytes(16) for i in range(60)}
    params = CuckooHashingSparseDpfPirServer.generate_params(60, seed=b"0123456789abcdef")
    db0 = _sparse_db(params, records)
    upserts = {b"key3": rng.bytes(16), b"aaaa1": rng.bytes(16)}
    merged = {**records, **upserts}
    journal = EventJournal()
    with SparsePlainSession(params, db0, CONFIG, device="cpu") as session:
        prober = Prober(session, sparse_records=records, journal=journal,
                        metrics=MetricsRegistry())
        assert prober.kinds() == ["sparse_kv", "sparse_absent"]
        assert [r["status"] for r in prober.run_cycle()] == ["pass", "pass"]
        manager = prober.bind_snapshots(SnapshotManager(session),
                                        lambda generation: merged)
        manager.stage(_sparse_db(params, upserts, prev=db0))
        manager.flip()
        assert prober.export()["generation"] == 1
        assert prober._sparse_keys[0] == b"aaaa1"  # re-picked from the new mapping
        assert [r["status"] for r in prober.run_cycle()] == ["pass", "pass"]
        assert [e["kind"] for e in journal.tail(kind="prober.goldens_rotated")] == [
            "prober.goldens_rotated"]
        # A stale oracle is caught: the rotated key's old value.
        prober._sparse_expected[0] = b"\x01" * 16
        assert prober.run_cycle()[0]["status"] == "mismatch"


def test_a_pin_holds_a_flip_off_until_it_is_released():
    db0 = DenseDpfPirDatabase(RECORDS, device="cpu")
    with PlainSession(db0, CONFIG, device="cpu") as session:
        manager = SnapshotManager(session)
        flips = []
        manager.add_flip_listener(flips.append)
        manager.stage(DenseDpfPirDatabase.Builder().update(3, b"x" * 8).build_from(db0))
        with manager.pin() as generation:
            assert generation == 0 and manager.export()["pins"] == 1
            with pytest.raises(TimeoutError, match="pins=1"):
                manager.flip(timeout=0.2)
        assert manager.export()["pins"] == 0
        record = manager.flip(timeout=5.0)
        assert (record["from_generation"], record["to_generation"]) == (0, 1)
        assert [f["to_generation"] for f in flips] == [1]


def test_wrong_bits_in_the_staging_then_recovery(tmp_path):
    db = DenseDpfPirDatabase(RECORDS, device="cpu")
    journal = EventJournal()
    bundles = BundleManager(str(tmp_path), journal=journal, cooldown_s=60.0)
    with PlainSession(db, CONFIG, device="cpu") as session:
        prober = _prober(session, journal=journal)
        bundles.add_source("probes", prober.export)
        prober.add_failure_listener(bundles.on_probe_failure)
        assert [r["status"] for r in prober.run_cycle()] == ["pass"] * 4
        row = prober._indices[1]
        assert chip_smoke.xor_staged_word(db, row, 1, -(1 << 31)) == 2  # staging + streaming
        results = prober.run_cycle()
        assert [r["status"] for r in results] == ["mismatch"] * 4
        assert all(f"index {row}" in r["detail"] for r in results)
        assert len(journal.tail(kind="prober.mismatch")) == 4
        assert bundles.export()["fired"] == 1  # the cooldown holds the other three
        assert bundles.bundles()[0]["sources"] == {"probes": "ok"}
        chip_smoke.xor_staged_word(db, row, 1, -(1 << 31))
        assert [r["status"] for r in prober.run_cycle()] == ["pass"] * 4
        assert len(journal.tail(kind="prober.recovered")) == 4


# -- parity with the JAX package's prober over stub sessions -----------------


class _StubServer:
    role = "plain"
    device = torch.device("cpu")

    def __init__(self):
        self.pair, self.records, self.fail = None, None, False

    def handle_plain_request(self, request):
        if self.fail:
            raise RuntimeError("synthetic server wreck")
        if request is self.pair[0]:
            masked = [bytes(len(r)) for r in self.records]
        else:
            masked = list(self.records)
        return types.SimpleNamespace(
            dpf_pir_response=types.SimpleNamespace(masked_response=masked))

    _dispatch_plain = handle_plain_request


class _StubSession:
    degraded = False

    def __init__(self):
        self.server = _StubServer()

    def handle_request(self, request):
        return self.server.handle_plain_request(request)


def _scripted_run(prober_cls, journal, registry):
    clock = FakeClock()
    session = _StubSession()
    prober = prober_cls(session, RECORDS, indices=[5, 77, 299], journal=journal,
                        metrics=registry, clock=clock, period_s=2.0,
                        freshness_window_s=5.0)
    session.server.pair = prober._plain_pair
    session.server.records = [RECORDS[i] for i in prober._indices]
    failures = []
    prober.add_failure_listener(lambda r: failures.append((r["kind"], r["status"])))
    cycles, fresh = [], []

    def cycle():
        clock.advance(1.0)
        cycles.append([(r["kind"], r["status"], r["detail"]) for r in prober.run_cycle()])
        fresh.append({k: {f: v for f, v in e.items() if f != "last_ms"}
                      for k, e in prober.freshness().items()})

    cycle()
    session.server.records[1] = bytes([session.server.records[1][0] ^ 0x80]) + \
        session.server.records[1][1:]
    cycle()
    clock.advance(6.0)  # past the freshness window since the last pass
    fresh.append(prober.freshness())
    session.server.records[1] = RECORDS[77]
    cycle()
    session.server.fail = True
    cycle()
    session.server.fail = False
    cycle()
    export = prober.export()
    for history in export["history"].values():
        for r in history:
            r.pop("ms")
            r.pop("t_wall")
    export["freshness"] = {k: {f: v for f, v in e.items() if f != "last_ms"}
                           for k, e in export["freshness"].items()}
    events = [{k: v for k, v in e.items() if k not in ("t_wall", "t_mono")}
              for e in journal.tail(n=100)]
    metrics = registry.export()
    return dict(cycles=cycles, fresh=[{k: {f: v for f, v in e.items() if f != "last_ms"}
                                       for k, e in f.items()} for f in fresh],
                failures=failures, export=export, events=events,
                counters=metrics["counters"],
                histograms={k: h["count"] for k, h in metrics["histograms"].items()},
                objective=vars(prober.rate_floor_objective()))


def test_control_logic_equals_jax():
    port = _scripted_run(Prober, EventJournal(), MetricsRegistry())
    jax_run = _scripted_run(JProber, JJournal(), JRegistry())
    assert port == jax_run
    statuses = [[s for _, s, _ in c] for c in port["cycles"]]
    assert statuses == [["pass"] * 4, ["mismatch"] * 4, ["pass"] * 4, ["error"] * 4,
                        ["pass"] * 4]
    assert port["fresh"][2]["pir_chunked"]["fresh"] is False
    kinds = [e["kind"] for e in port["events"]]
    assert kinds.count("prober.mismatch") == 4 and kinds.count("prober.recovered") == 8
    assert port["counters"]["prober.errors{kind=pir_streaming}"] == 1


def _loop_waits(prober_cls, journal, registry, took_s):
    clock = FakeClock()
    prober = prober_cls(_StubSession(), RECORDS, journal=journal, metrics=registry,
                        clock=clock, period_s=0.5, jitter=0.2, max_duty_cycle=0.05)
    waits = []

    def stop_after_one(timeout):
        waits.append(timeout)
        return True

    prober.run_cycle = lambda: clock.advance(took_s)
    prober._stop.wait = stop_after_one
    prober.start()
    prober._thread.join(timeout=10)
    assert not prober._thread.is_alive()
    prober._thread = None
    return waits


@pytest.mark.parametrize("took_s", [0.0, 0.01, 1.0])
def test_duty_cycle_bounds_the_loop_as_jax(took_s):
    waits = _loop_waits(Prober, EventJournal(), MetricsRegistry(), took_s)
    assert waits == _loop_waits(JProber, JJournal(), JRegistry(), took_s)
    # A cycle of d seconds sleeps at least d * (1 / 0.05 - 1).
    assert waits[0] >= took_s * 19.0 - 1e-9
    assert waits[0] >= 0.5 * 0.8 - 1e-9
