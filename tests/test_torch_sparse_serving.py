"""The port's sparse serving sessions and cuckoo rotation against the JAX
package's, on the CPU.

At `tests/test_torch_sparse_pir.py`'s small shape (60 keys, 90 buckets,
one selection block, 8 queries a request: 24 keys, one 32-key bucket in
every session), with the port's database built by its own builder (the
JAX layout, checked):

* the wire bytes of every role equal the JAX sessions' for the same
  request bytes: a plain request, a Leader request (each Leader behind
  its own package's Helper) and the bare Helper leg the JAX Leader sends;
* `Builder.build_from`'s slots equal the JAX package's (overwrites, new
  keys, evictions of old keys), and the delta's rows are exactly the
  buckets whose key or value changed in the JAX generation;
* a rotation through `SnapshotManager` stages only those rows, and the
  rotated session answers the JAX generation's bytes; a database of
  another geometry is refused as `SnapshotMismatch`;
* sparse sessions price the "sparse" workload for admission and feed the
  ledger's "sparse" cells.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.observability import propagation as jprop
from distributed_point_functions_tpu.pir import (
    CuckooHashedDpfPirDatabase as JDatabase,
    CuckooHashingSparseDpfPirClient as JClient,
    CuckooHashingSparseDpfPirServer as JServer,
)
from distributed_point_functions_tpu.serving import InProcessTransport as JTransport
from distributed_point_functions_tpu.serving import ServingConfig as JConfig
from distributed_point_functions_tpu.serving import sparse as jsparse
from distributed_point_functions_tpu.testing import encrypt_decrypt as jed
from distributed_point_functions_tpu_torch.observability import costmodel
from distributed_point_functions_tpu_torch.pir import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingSparseDpfPirServer,
    KeyNotFound,
)
from distributed_point_functions_tpu_torch.serving import (
    InProcessTransport,
    ServingConfig,
    SnapshotManager,
    SnapshotMismatch,
    SparseHelperSession,
    SparseLeaderSession,
    SparsePlainSession,
    make_sparse_client,
    sparse_lookup,
    sparse_lookup_plain,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

SEED = b"0123456789abcdef"
NUM_KEYS = 60
QUERIES = 8
TIMEOUT_MS = 120_000.0


def _records(rng, n):
    return {b"key%d" % i: rng.bytes(16) for i in range(n)}


def _port_db(params, records, generation=0):
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(params).set_generation(generation)
    for kv in records.items():
        builder.insert(kv)
    return builder.build(device="cpu")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1616)
    records = _records(rng, NUM_KEYS)
    params = JServer.generate_params(NUM_KEYS, seed=SEED)
    jbuilder = JDatabase.Builder().set_params(params)
    for kv in records.items():
        jbuilder.insert(kv)
    jdb = jbuilder.build()
    pparams = CuckooHashingSparseDpfPirServer.generate_params(NUM_KEYS, seed=SEED)
    keys = list(records)
    picked = [keys[int(i)] for i in rng.choice(NUM_KEYS, QUERIES - 2, replace=False)]
    queries = picked[:3] + [b"absent-1"] + picked[3:] + [b"key-not-here"]
    # Overwrites, new keys: generation 1.
    upserts = {keys[int(i)]: rng.bytes(16) for i in rng.choice(NUM_KEYS, 10, replace=False)}
    upserts.update({b"new%d" % i: rng.bytes(16) for i in range(15)})
    return dict(records=records, params=params, pparams=pparams, jdb=jdb,
                queries=queries, upserts=upserts,
                jconfig=JConfig(request_timeout_ms=TIMEOUT_MS),
                config=ServingConfig(request_timeout_ms=TIMEOUT_MS))


def test_the_port_builder_gives_the_jax_layout(case):
    db = _port_db(case["pparams"], case["records"])
    assert db.slots == case["jdb"].slots
    assert db.key_database.record(3) == case["jdb"].key_database.record(3).ljust(
        db.key_size, b"\0")


def test_plain_session_wire_equals_jax(case):
    jclient = JClient.create(case["params"], jed.encrypt)
    r0, r1 = jclient.create_plain_requests(case["queries"])
    with jsparse.SparsePlainSession(case["params"], case["jdb"], case["jconfig"]) as jsession, \
            SparsePlainSession(case["pparams"], _port_db(case["pparams"], case["records"]),
                               case["config"], device="cpu") as session:
        for r in (r0, r1):
            wire = jser.pir_request_to_proto(jsession.server.dpf, r).SerializeToString()
            assert session.handle_wire(wire) == jsession.handle_wire(wire)
        client = make_sparse_client(session)
        got = sparse_lookup_plain(session, client, case["queries"])
    assert got == [case["records"].get(q, KeyNotFound(q)) for q in case["queries"]]


def test_leader_and_helper_wire_equal_jax(case):
    jclient = JClient.create(case["params"], jed.encrypt)
    request, _ = jclient.create_request(case["queries"])
    jhelper = jsparse.SparseHelperSession(case["params"], case["jdb"], jed.decrypt,
                                          case["jconfig"])
    legs = []

    def recording(data):
        legs.append(data)
        return jhelper.handle_wire(data)

    helper = SparseHelperSession(case["pparams"], _port_db(case["pparams"], case["records"]),
                                 encrypt_decrypt.decrypt, case["config"], device="cpu")
    with jsparse.SparseLeaderSession(case["params"], case["jdb"], JTransport(recording),
                                     case["jconfig"]) as jleader, \
            SparseLeaderSession(case["pparams"], _port_db(case["pparams"], case["records"]),
                                InProcessTransport(helper.handle_wire), case["config"],
                                device="cpu") as leader:
        wire = jser.pir_request_to_proto(jleader.server.dpf, request).SerializeToString()
        assert leader.handle_wire(wire) == jleader.handle_wire(wire)
        _, bare, _, _ = jprop.try_decode_request_ext(legs[0])
        assert helper.handle_wire(bare) == jhelper.handle_wire(bare)
        client = make_sparse_client(leader, encrypt_decrypt.encrypt)
        got = sparse_lookup(leader, client, case["queries"])
    assert got == [case["records"].get(q, KeyNotFound(q)) for q in case["queries"]]
    helper.close()
    jhelper.close()


def _jax_generation1(case):
    jbuilder = JDatabase.Builder()
    for kv in case["upserts"].items():
        jbuilder.insert(kv)
    return jbuilder.build_from(case["jdb"])


def test_build_from_slots_and_delta_rows_equal_jax(case):
    jdb1 = _jax_generation1(case)
    prev = _port_db(case["pparams"], case["records"])
    builder = CuckooHashedDpfPirDatabase.Builder()
    for kv in case["upserts"].items():
        builder.insert(kv)
    db1 = builder.build_from(prev)
    assert db1.slots == jdb1.slots and db1.generation == jdb1.generation == 1
    assert db1.size == jdb1.size == NUM_KEYS + 15
    jdb0 = case["jdb"]
    changed = sorted(
        b for b in range(jdb0.num_buckets)
        if (jdb1.key_database.record(b), jdb1.value_database.record(b))
        != (jdb0.key_database.record(b), jdb0.value_database.record(b)))
    moved = [b for b in changed if jdb1.slots[b] != jdb0.slots[b]
             and jdb0.slots[b] is not None]
    assert moved  # an insertion evicted an old key
    assert db1.dense_database._delta_rows.tolist() == changed
    for b in range(jdb0.num_buckets):
        assert db1.value_at(b) == jdb1.value_database.record(b).ljust(16, b"\0")


def test_rotation_stages_the_delta_and_serves_the_jax_generation(case):
    jdb1 = _jax_generation1(case)
    jclient = JClient.create(case["params"], jed.encrypt)
    queries = case["queries"][:4] + [b"new3", b"new14", b"key-not-here", b"new0"]
    r0, _ = jclient.create_plain_requests(queries)
    prev = _port_db(case["pparams"], case["records"])
    builder = CuckooHashedDpfPirDatabase.Builder()
    for kv in case["upserts"].items():
        builder.insert(kv)
    with SparsePlainSession(case["pparams"], prev, case["config"], device="cpu") as session, \
            jsparse.SparsePlainSession(case["params"], jdb1, case["jconfig"]) as jsession:
        manager = SnapshotManager(session)
        wire = jser.pir_request_to_proto(jsession.server.dpf, r0).SerializeToString()
        session.handle_wire(wire)  # generation 0 is staged
        db1 = builder.build_from(prev)
        manager.stage(db1)
        stage = manager.export()["last_stage"]
        rows = len(db1.dense_database._delta_rows)
        assert stage["mode"] == "delta" and stage["bytes_saved"] > 0
        assert stage["bytes_staged"] == rows * 8 + rows * 4 * db1.dense_database._record_words
        manager.flip()
        assert session.handle_wire(wire) == jsession.handle_wire(wire)
        got = sparse_lookup_plain(session, make_sparse_client(session), queries)
        merged = {**case["records"], **case["upserts"]}
        assert got == [merged.get(q, KeyNotFound(q)) for q in queries]
        assert manager.export()["drains"][0]["generation"] == 0
        # Another geometry: refused before anything is staged.
        other = _port_db(CuckooHashingSparseDpfPirServer.generate_params(
            NUM_KEYS, seed=b"fedcba9876543210"), case["records"], generation=2)
        with pytest.raises(SnapshotMismatch):
            manager.stage(other)
        wide = dict(case["records"])
        wide[b"key1"] = b"x" * 40  # wider values: another row layout
        with pytest.raises(SnapshotMismatch):
            manager.stage(_port_db(case["pparams"], wide, generation=2))


def test_sparse_sessions_price_the_sparse_workload(case):
    previous = costmodel.set_default_cost_ledger(costmodel.CostLedger(window_size=4))
    try:
        config = ServingConfig(request_timeout_ms=TIMEOUT_MS, admission_enabled=True)
        with SparsePlainSession(case["pparams"], _port_db(case["pparams"], case["records"]),
                                config, device="cpu") as session:
            client = make_sparse_client(session)
            sparse_lookup_plain(session, client, case["queries"][:2])
            decision = session.admission.admit(6)
            assert decision.cost.unit == "sparse_keys"
            session.admission.release(decision.cost)
            cells = costmodel.default_cost_ledger().export()["cells"]
        assert cells and all(name.startswith("sparse/") for name in cells)
    finally:
        costmodel.set_default_cost_ledger(previous)
