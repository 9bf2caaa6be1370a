"""The pipelined staging of a dense database against the JAX package's
staged layouts, bit for bit.

The port stages the host image in slabs of whole 4,096-record tiles
(`pir.database.stage_bitmajor`); every layout derived from that staging
must equal the JAX package's: the bit-major staging (`_staged_perm`), the
row-major words (`db_words`), the streaming chunks at each cut
(`streaming_chunks(cut_levels=c, bitmajor=True)`) and the chunked tier's
padded rows (what `DenseDpfPirServer._chunked_database` builds). Sizes: a
count of one tile (1,024 x 8 B), a count that is not a multiple of 4,096
(5,000 x 20 B) and one of ten tiles (40,000 x 4 B, eight uneven slabs),
each also staged directly at 1, 2 and 8 slabs. A delta generation staged
from its base's staging equals the JAX package's full build of the same
records. The transfer ledger's overlap accounting exports as the JAX
package's does.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.observability.device import (
    TransferLedger as JTransferLedger,
)
from distributed_point_functions_tpu.pir import DenseDpfPirDatabase as JDatabase
from distributed_point_functions_tpu.pir.planner import (
    CHUNK_GRANULE_LEVELS as J_GRANULE_LEVELS,
)
from distributed_point_functions_tpu_torch.observability.device import TransferLedger
from distributed_point_functions_tpu_torch.ops.inner_product_kernels import (
    permute_db_bitmajor,
)
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
from distributed_point_functions_tpu_torch.pir import DenseDpfPirDatabase
from distributed_point_functions_tpu_torch.pir.database import (
    MAX_STAGING_SLABS,
    TILE_RECORDS,
    slab_spans,
    stage_bitmajor,
)
from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry

SIZES = [(1024, 8), (5000, 20), (40_000, 4)]


def _records(n, size, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(size) for _ in range(n)]


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def pair(request):
    n, size = request.param
    records = _records(n, size, n + size)
    return records, DenseDpfPirDatabase(records, device="cpu"), JDatabase(records)


def test_slab_spans_cover_whole_tiles():
    assert slab_spans(1024) == [(0, 4096)]
    assert slab_spans(5120, 8) == [(0, 4096), (4096, 8192)]
    spans = slab_spans(40_064)
    assert len(spans) == MAX_STAGING_SLABS
    assert spans[0][0] == 0 and spans[-1][1] == 10 * TILE_RECORDS
    assert all(a % TILE_RECORDS == 0 and b > a for a, b in spans)
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert slab_spans(40_064, 1) == [(0, 10 * TILE_RECORDS)]


def test_staging_equals_jax_layouts(pair):
    records, db, jdb = pair
    staged = to_numpy(db.staged())
    assert np.array_equal(staged, np.asarray(jdb._staged_perm()))
    assert np.array_equal(to_numpy(db.db_words), np.asarray(jdb.db_words))
    levels = max(0, (db.num_selection_blocks - 1).bit_length())
    for cut in sorted({0, 1, levels}):
        want = np.asarray(jdb.streaming_chunks(cut_levels=cut, bitmajor=True))
        assert np.array_equal(to_numpy(db.streaming_chunks(cut)), want), cut
    granule = 1 << min(levels, J_GRANULE_LEVELS)
    padded_blocks = -(-db.num_selection_blocks // granule) * granule
    rows = np.asarray(jdb.db_words)
    want = np.zeros((padded_blocks * 128, rows.shape[1]), dtype=np.uint32)
    want[: rows.shape[0]] = rows
    chunked = to_numpy(db.chunked_staging(granule))
    got = chunked.transpose(1, 0, 2).reshape(-1, chunked.shape[2])
    assert np.array_equal(got[: want.shape[0]], want)
    assert not got[want.shape[0]:].any()


@pytest.mark.parametrize("slabs", [1, 2, 8])
@pytest.mark.parametrize("n,size", SIZES)
def test_every_slab_count_gives_the_one_copy_staging(n, size, slabs):
    db = DenseDpfPirDatabase(_records(n, size, n + size), device="cpu")
    host = db.host_rows()
    got = stage_bitmajor(host, torch.device("cpu"), slabs=slabs)
    assert torch.equal(got, permute_db_bitmajor(to_tensor(host, "cpu")))
    assert len(slab_spans(host.shape[0], slabs)) == min(slabs, -(-n // TILE_RECORDS))


@pytest.mark.parametrize("n,size", SIZES[:2])
def test_delta_prestage_equals_jax_full_build(n, size):
    records = _records(n, size, 7)
    db0 = DenseDpfPirDatabase(records, device="cpu")
    db0.staged()
    rng = np.random.default_rng(8)
    rows = sorted({int(i) for i in rng.integers(0, n, 9)})
    builder = DenseDpfPirDatabase.Builder()
    updated = list(records)
    for i in rows:
        updated[i] = rng.bytes(size)
        builder.update(i, updated[i])
    db1 = builder.build_from(db0)
    db1.prestage()
    assert db1.last_prestage_stats["mode"] == "delta"
    assert np.array_equal(to_numpy(db1.staged()),
                          np.asarray(JDatabase(updated)._staged_perm()))


def _ledger_calls(ledger):
    ledger.record_h2d(4096, "db_staging")
    ledger.record_h2d(4096, "db_staging")
    ledger.record_overlap(1.2345, "db_staging")
    ledger.record_overlap(0.0, "db_staging")  # nothing hidden: no entry change
    ledger.record_sync("db_staging", wait_ms=0.5)
    ledger.record_d2h(64, "result_readback")
    ledger.record_overlap(2.0, "key_staging")
    return ledger


def test_ledger_overlap_exports_as_jax():
    port, jax_ledger = _ledger_calls(TransferLedger()), _ledger_calls(JTransferLedger())
    assert port.export() == jax_ledger.export()
    assert port.overlapped_ms("db_staging") == pytest.approx(1.2345)
    assert port.overlapped_ms() == pytest.approx(3.2345)
    assert port.copies("db_staging") == 2 and port.syncs("db_staging") == 1
    port.reset()
    assert port.export()["totals"]["overlapped_ms"] == 0.0


def test_ledger_overlap_reaches_the_registry():
    registry = MetricsRegistry()
    ledger = TransferLedger(registry)
    ledger.record_overlap(3.5, "db_staging")
    counters = registry.export()["counters"]
    assert counters["device.overlapped_ms{phase=db_staging}"] == pytest.approx(3.5)
