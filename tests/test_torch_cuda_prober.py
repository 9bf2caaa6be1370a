"""The pipelined staging and the blackbox prober on the card.

Marked `cuda`; each test skips without a CUDA device. With numpy seeds:

* a 2^20 x 64 B database stages in 8 slabs: the staging equals the
  one-copy staging (`permute_db_bitmajor` of the whole image moved in one
  copy) bit for bit, the transfer ledger shows 8 `db_staging` copies, one
  sync and a positive `overlapped_ms`, and the device's peak stays under
  1.5x the staging; a ragged count (5,000 x 20 B) stages equal as well;
* every prober kind passes on the card at 2^12 x 32 B (a Leader and its
  Helper, `hh_sweep`, a sparse session), each dense kind, `leader_e2e`
  and `hh_sweep` launching exactly its plan (`chip_smoke.
  probe_want_launches`);
* a word XORed into a golden row of every staging turns each dense kind
  to `mismatch`, and undoing it to `recovered`.

This file imports no JAX, so on a machine with a card and without JAX it
runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_prober.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.heavy_hitters import HeavyHittersConfig
from distributed_point_functions_tpu_torch.observability.device import default_telemetry
from distributed_point_functions_tpu_torch.observability.events import EventJournal
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops.inner_product_kernels import (
    permute_db_bitmajor,
)
from distributed_point_functions_tpu_torch.ops.words import to_tensor
from distributed_point_functions_tpu_torch.pir import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingSparseDpfPirServer,
    DenseDpfPirDatabase,
)
from distributed_point_functions_tpu_torch.pir import server as pir_server
from distributed_point_functions_tpu_torch.serving import (
    HelperSession,
    InProcessTransport,
    LeaderSession,
    ServingConfig,
    SparsePlainSession,
)
from distributed_point_functions_tpu_torch.serving.metrics import MetricsRegistry
from distributed_point_functions_tpu_torch.serving.prober import Prober
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402 - the plans' launch counts, the staging XOR

pytestmark = pytest.mark.cuda

NUM_RECORDS = 1 << 12
RECORD_BYTES = 32
# Covers a first request's build of the kernels.
CONFIG = ServingConfig(max_batch_size=8, max_wait_ms=2.0, request_timeout_ms=600_000.0)
DENSE_KINDS = ["pir_materialized", "pir_streaming", "pir_chunked", "pir_unbatched"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clear_tier_floor():
    yield
    pir_server.clear_tier_floor()


@pytest.mark.parametrize("n,size,slabs", [(1 << 20, 64, 8), (5000, 20, 2)])
def test_pipelined_staging_equals_one_copy(dev, n, size, slabs):
    rng = np.random.default_rng(n)
    words = np.zeros((-(-n // 128) * 128, size // 4), dtype=np.uint32)
    words[:n] = rng.integers(0, 1 << 32, (n, size // 4), dtype=np.uint32)
    db = DenseDpfPirDatabase.from_words(words, n, size, device=dev)
    ledger = default_telemetry().transfers
    before = (ledger.copies("db_staging"), ledger.syncs("db_staging"),
              ledger.overlapped_ms("db_staging"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    staged = db.staged()
    peak = torch.cuda.max_memory_allocated(dev) - base
    copies = ledger.copies("db_staging") - before[0]
    syncs = ledger.syncs("db_staging") - before[1]
    overlapped = ledger.overlapped_ms("db_staging") - before[2]
    assert (copies, syncs) == (slabs, 1)
    assert overlapped > 0
    # Two slabs in flight beside the staging: 1.25x at 8 slabs.
    nbytes = staged.numel() * 4
    assert peak <= nbytes * (1 + 2 / slabs), (peak, nbytes)
    if slabs == 8:
        assert peak < 1.5 * nbytes
    assert torch.equal(staged, permute_db_bitmajor(to_tensor(words, dev)))


def _records(seed, n=NUM_RECORDS):
    rng = np.random.default_rng(seed)
    return [rng.bytes(RECORD_BYTES) for _ in range(n)]


def test_every_kind_passes_on_the_card_with_its_plan(dev):
    records = _records(2121)
    helper = HelperSession(DenseDpfPirDatabase(records, device=dev),
                           encrypt_decrypt.decrypt, CONFIG, device=dev)
    leader_db = DenseDpfPirDatabase(records, device=dev)
    leader = LeaderSession(leader_db, InProcessTransport(helper.handle_wire), CONFIG,
                           device=dev)
    try:
        journal = EventJournal()
        prober = Prober(leader, records, encrypter=encrypt_decrypt.encrypt,
                        hh_values=[3, 3, 3, 77, 77, 9, 9, 200],
                        hh_config=HeavyHittersConfig(domain_bits=8, level_bits=4,
                                                     threshold=2),
                        journal=journal, metrics=MetricsRegistry())
        assert prober.kinds() == DENSE_KINDS + ["leader_e2e", "hh_sweep"]
        prober.run_cycle()  # builds every tier's staging
        for kind in prober.kinds():
            cuda_lib.reset_launch_counts()
            result = prober._run_one(kind)
            torch.cuda.synchronize()
            got = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            assert result["status"] == "pass", result
            assert got == chip_smoke.probe_want_launches(prober, kind), kind
        row = prober._indices[0]
        assert chip_smoke.xor_staged_word(leader_db, row, 0, 0x10) >= 2
        results = {r["kind"]: r["status"] for r in prober.run_cycle()}
        assert [results[k] for k in DENSE_KINDS] == ["mismatch"] * 4
        chip_smoke.xor_staged_word(leader_db, row, 0, 0x10)
        assert all(r["status"] == "pass" for r in prober.run_cycle())
        assert len(journal.tail(kind="prober.recovered")) >= 4
    finally:
        leader.close()
        helper.close()


def test_sparse_kinds_pass_on_the_card(dev):
    rng = np.random.default_rng(2222)
    records = {b"k%06d" % i: rng.bytes(16) for i in range(1000)}
    params = CuckooHashingSparseDpfPirServer.generate_params(1000, seed=b"0123456789abcdef")
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(params)
    for kv in records.items():
        builder.insert(kv)
    with SparsePlainSession(params, builder.build(device=dev), CONFIG, device=dev) as session:
        prober = Prober(session, sparse_records=records, journal=EventJournal(),
                        metrics=MetricsRegistry())
        for _ in range(2):
            assert [(r["kind"], r["status"]) for r in prober.run_cycle()] == [
                ("sparse_kv", "pass"), ("sparse_absent", "pass")]
