"""Sparse PIR on the card, against the plain versions.

Marked `cuda`; each test skips without a CUDA device. At chip_smoke's
`sparse_small` shape (3,000 keys: 4,500 buckets, 36 selection blocks under
a covering tree of 64) and at 60 keys (one block), a sparse server on the
card must answer with the bytes of a `device="cpu"` server on the same
database, in each expansion mode and on each serving tier, and a Leader
and a Helper on the card must resolve every present key to its value and
every absent one to `KeyNotFound`. This file imports no JAX, so on a
machine with a card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_sparse.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.pir import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingSparseDpfPirClient,
    CuckooHashingSparseDpfPirServer,
    KeyNotFound,
)
from distributed_point_functions_tpu_torch.pir import server as server_mod
from distributed_point_functions_tpu_torch.pir.dense_eval_planes import EXPANSION_MODES
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

pytestmark = pytest.mark.cuda

SEED = b"0123456789abcdef"
TIERS = ("materialized", "streaming", "chunked")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(num_keys, dev):
    rng = np.random.default_rng(num_keys)
    records = {b"k%012d" % i: rng.bytes(int(rng.integers(0, 17))) for i in range(num_keys)}
    params = CuckooHashingSparseDpfPirServer.generate_params(num_keys, seed=SEED)
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(params)
    for kv in records.items():
        builder.insert(kv)
    keys = list(records)
    queries = [keys[int(i)] for i in rng.integers(0, num_keys, 30)] + [b"absent", b"k-1"]
    return records, params, builder.build(device=dev), builder.build(device="cpu"), queries


@pytest.mark.parametrize("num_keys", [3000, 60])
@pytest.mark.parametrize("expansion", EXPANSION_MODES)
def test_card_bytes_equal_plain_on_every_tier(dev, num_keys, expansion):
    records, params, gpu_db, cpu_db, queries = _case(num_keys, dev)
    gpu = CuckooHashingSparseDpfPirServer.create_plain(params, gpu_db, device=dev,
                                                       expansion=expansion)
    cpu = CuckooHashingSparseDpfPirServer.create_plain(params, cpu_db, device="cpu",
                                                       expansion=expansion)
    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        gpu.get_public_params(), encrypt_decrypt.encrypt)
    requests = client.create_plain_requests(queries)
    want = [cpu.handle_request(r).dpf_pir_response.masked_response for r in requests]
    tiers = TIERS if gpu_db.num_selection_blocks > 1 else TIERS[:1]
    for tier in tiers:
        server_mod.set_tier_floor(tier)
        try:
            assert gpu.dense_server._plan_serving(3 * len(queries)).mode == tier
            cuda_lib.reset_launch_counts()
            got = [gpu.handle_request(r).dpf_pir_response.masked_response for r in requests]
            torch.cuda.synchronize()
        finally:
            server_mod.clear_tier_floor()
        assert got == want, tier
        assert cuda_lib.LAUNCHES["leaf_blocks"] >= 2
    raw = [bytes(a ^ b for a, b in zip(x, y)) for x, y in zip(*want)]
    for q, v in zip(queries, client._match(raw, queries)):
        if q in records:
            assert v == records[q] + bytes(cpu_db.value_size - len(records[q]))
        else:
            assert v is None


def test_leader_helper_on_the_card(dev):
    records, params, gpu_db, _, queries = _case(3000, dev)
    helper = CuckooHashingSparseDpfPirServer.create_helper(
        params, gpu_db, encrypt_decrypt.decrypt, device=dev)

    def sender(helper_request, while_waiting):
        while_waiting()
        return helper.handle_request(helper_request)

    leader = CuckooHashingSparseDpfPirServer.create_leader(params, gpu_db, sender, device=dev)
    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        leader.get_public_params(), encrypt_decrypt.encrypt)
    request, state = client.create_request(queries)
    cuda_lib.reset_launch_counts()
    resolved = client.resolve(leader.handle_request(request), state)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["xor_inner_product"] == 2
    assert cuda_lib.LAUNCHES["walk_descend"] == 4
    for q, v in zip(queries, resolved):
        if q in records:
            assert v == records[q] + bytes(gpu_db.value_size - len(records[q]))
        else:
            assert v == KeyNotFound(q) and not v
