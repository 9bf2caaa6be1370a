"""Database generations and their rotation under traffic.

On the CPU (numpy seeds): `Builder().update(...).build_from(prev)` gives
the same rows as the JAX package's, for a delta that fits `prev`'s rows
and for one that widens the records and appends, from a `prev` that
still holds its host image and from one that is staged (its rows read
back); a delta's `prestage` reports mode "delta" with `bytes_saved > 0`
and stages exactly the full staging of its records; `release_stagings`
frees its buffers. Then a `RotationCoordinator` rotates a Leader and a
Helper session to generation 1 while 8 threads query the updated
records: every answer is one generation's record (generation 0 or 1,
never the XOR of two), every answer after the rotation is generation
1's, and the retired generation's staging is freed. Bit-exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.pir import DenseDpfPirDatabase as JDatabase
from distributed_point_functions_tpu_torch.pir import DenseDpfPirClient, DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    InProcessTransport,
    LeaderSession,
    RotationCoordinator,
    ServingConfig,
    SnapshotManager,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt


def _records(rng, n, size):
    return [rng.bytes(int(rng.integers(1, size + 1))) for _ in range(n)]


def _jax_db(records):
    b = JDatabase.Builder()
    for r in records:
        b.insert(r)
    return b.build()


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("kind", ["delta", "widen", "append"])
def test_build_from_rows_equal_jax(kind, staged):
    rng = np.random.default_rng(77)
    records = _records(rng, 300, 24)
    prev = DenseDpfPirDatabase(records, device="cpu")
    if staged:
        prev.staged()  # drops the host image: build_from reads the staging
    jprev = _jax_db(records)
    builder, jbuilder = DenseDpfPirDatabase.Builder(), JDatabase.Builder()
    for i in rng.choice(300, 20, replace=False):
        value = rng.bytes(int(rng.integers(0, 25 if kind != "widen" else 40)))
        builder.update(int(i), value)
        jbuilder.update(int(i), value)
    if kind == "append":
        for _ in range(40):
            value = rng.bytes(8)
            builder.insert(value)
            jbuilder.insert(value)
    new, jnew = builder.build_from(prev), jbuilder.build_from(jprev)
    assert (new.generation, new.size, new.max_value_size) == (
        jnew.generation, jnew.size, jnew.max_value_size)
    np.testing.assert_array_equal(new.host_rows(), jnew._host_words)
    assert (new._delta_rows is not None) == (kind == "delta")


def test_delta_prestage_stages_only_the_rows():
    rng = np.random.default_rng(5)
    records = _records(rng, 1000, 32)
    prev = DenseDpfPirDatabase(records, device="cpu")
    prev.staged()
    builder = DenseDpfPirDatabase.Builder()
    updated = dict(records=list(records))
    for i in rng.choice(1000, 64, replace=False):
        value = rng.bytes(32)
        builder.update(int(i), value)
        updated["records"][int(i)] = value
    new = builder.build_from(prev)
    moved = new.prestage()
    stats = new.last_prestage_stats
    assert stats["mode"] == "delta" and stats["bytes_saved"] > 0
    assert stats["bytes_staged"] == moved == 64 * (8 + 32)
    assert stats["bytes_full_image"] == 1024 * 32 and stats["generation"] == 1
    want = DenseDpfPirDatabase(updated["records"], device="cpu").staged()
    assert torch.equal(new.staged(), want)
    assert new.prestage() == 0
    # The base is untouched, and its release frees only its own buffer.
    assert torch.equal(prev.staged(), DenseDpfPirDatabase(records, device="cpu").staged())
    assert prev.staged_bytes() > 0
    assert prev.release_stagings() == 1 and prev.staged_bytes() == 0
    with pytest.raises(RuntimeError, match="released"):
        prev.staged()
    assert torch.equal(new.staged(), want)


def test_rotation_under_threaded_traffic_is_single_generation():
    rng = np.random.default_rng(9)
    n = 256
    gen0 = [rng.bytes(16) for _ in range(n)]
    hot = [int(i) for i in rng.choice(n, 8, replace=False)]
    gen1 = list(gen0)
    builder = DenseDpfPirDatabase.Builder()
    for i in hot:
        gen1[i] = rng.bytes(16)
        builder.update(i, gen1[i])
    # The requests carry a deadline, so that a stalled batch fails the
    # test instead of holding the test process.
    config = ServingConfig(max_batch_size=8, max_wait_ms=1.0, request_timeout_ms=10_000.0)
    ldb = DenseDpfPirDatabase(gen0, device="cpu")
    hdb = DenseDpfPirDatabase(gen0, device="cpu")
    helper = HelperSession(hdb, encrypt_decrypt.decrypt, config=config, device="cpu")
    leader = LeaderSession(ldb, InProcessTransport(helper.handle_wire), config=config,
                           device="cpu")
    lm, hm = SnapshotManager(leader), SnapshotManager(helper)
    client = DenseDpfPirClient.create(n, encrypt_decrypt.encrypt)
    answers = []
    stop = threading.Event()
    lock = threading.Lock()
    errors = []

    def traffic(t):
        k = 0
        while not stop.is_set():
            i = hot[(t + k) % len(hot)]
            request, state = client.create_request([i])
            try:
                got = client.handle_response(leader.handle_request(request), state)[0]
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                return
            with lock:
                answers.append((i, got))
            k += 1

    def wait_for_answers(n):
        deadline = time.monotonic() + 60
        while len(answers) < n and not errors:
            assert time.monotonic() < deadline, "traffic stalled"
            time.sleep(0.005)

    threads = [threading.Thread(target=traffic, args=(t,), daemon=True)
               for t in range(8)]
    try:
        with leader, helper:
            request, state = client.create_request([hot[0]])
            assert client.handle_response(leader.handle_request(request), state) == [
                gen0[hot[0]]]
            for t in threads:
                t.start()
            wait_for_answers(16)
            report = RotationCoordinator(lm, hm).rotate(builder.build_from(ldb),
                                                        builder.build_from(hdb))
            wait_for_answers(len(answers) + 16)
            stop.set()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), "a traffic thread never finished"
            after = []
            for i in hot:
                request, state = client.create_request([i])
                after.append(client.handle_response(leader.handle_request(request), state)[0])
    finally:
        stop.set()
    assert not errors, errors[0]
    assert report["to_generation"] == 1
    assert leader.server.database.generation == helper.server.database.generation == 1
    for i, got in answers:
        assert got in (gen0[i], gen1[i])
    assert after == [gen1[i] for i in hot]
    for m in (lm, hm):
        out = m.export()
        assert out["last_stage"]["mode"] == "delta" and out["last_stage"]["bytes_saved"] > 0
        assert [d["generation"] for d in out["drains"]] == [0]
        assert out["drains"][0]["bytes_freed"] > 0
    assert ldb.staged_bytes() == hdb.staged_bytes() == 0
