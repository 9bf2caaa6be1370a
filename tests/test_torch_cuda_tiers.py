"""K7, K9, K1's accumulate entry, `leaf_blocks` and the serving tiers on
the card, against their plain versions on the host, and K5's memory.

Marked `cuda`; each test skips without a CUDA device. The shapes are small
and ragged. This file imports no JAX, so on a machine with a card and
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_tiers.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.capacity.model import (
    CapacityModel,
    set_default_capacity_model,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
from distributed_point_functions_tpu_torch.ops.inner_product import xor_counts_plain
from distributed_point_functions_tpu_torch.ops.words import to_tensor
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt
from distributed_point_functions_tpu_torch.pir import server as server_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(rng, shape, device):
    return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), device)


@pytest.mark.parametrize("nq,g,w", [(12, 8, 1), (33, 200, 8), (8, 4096, 64)])
def test_xor_counts_matches_plain(dev, nq, g, w):
    rng = np.random.default_rng(g)
    db, packed = _words(rng, (32, g, w), dev), _words(rng, (nq, g), dev)
    before = cuda_lib.LAUNCHES["xor_counts"]
    got = ipk.xor_counts(db, packed)
    assert cuda_lib.LAUNCHES["xor_counts"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, xor_counts_plain(db, packed))


def test_accumulate_xors_in_place_without_zeroing(dev):
    rng = np.random.default_rng(3)
    db, sel = _words(rng, (32, 256, 5), dev), _words(rng, (20, 64, 4), dev)
    acc0 = _words(rng, (20, 5), dev)
    acc = acc0.clone()
    # Two group spans of one staging, each a strided view.
    for h in (0, 1):
        ipk.xor_inner_product_accumulate(acc, db[:, 128 * h:128 * (h + 1)],
                                         sel[:, 32 * h:32 * (h + 1)])
    torch.cuda.synchronize()
    assert torch.equal(acc, acc0 ^ ipk.xor_inner_product_staged(db, sel))
    assert torch.equal(acc.cpu(), acc0.cpu() ^ ipk.xor_inner_product_staged(db.cpu(), sel.cpu()))


@pytest.mark.parametrize("rows,n,factor", [(1, 2, 2), (3, 5, 7), (256, 128, 32)])
def test_repeat_tiles_matches_plain(dev, rows, n, factor):
    x = _words(np.random.default_rng(n), (rows, n), dev)
    assert torch.equal(ipk.repeat_tiles(x, factor), ipk.repeat_tiles_plain(x, factor))
    assert ipk.interpret_repeat_tiles(dev) is True


# A tile holds T blocks: 32 at KG = 1, 8 at KG = 4, 2 at KG = 32; block
# counts below, at and past one tile, ragged ones, and KG past a tile's 32
# key groups.
@pytest.mark.parametrize("kg,nodes,num_blocks", [(1, 2, 2), (3, 16, 11), (32, 64, 64),
                                                  (4, 8, 12), (4, 64, 7), (4, 64, 8),
                                                  (4, 64, 9), (1, 64, 32), (1, 64, 33),
                                                  (32, 8, 3), (33, 4, 4), (8, 100, 101)])
def test_leaf_blocks_matches_plain(dev, kg, nodes, num_blocks):
    rng = np.random.default_rng(nodes)
    values = _words(rng, (16, 8, kg * nodes), dev)
    node_block = np.full(nodes, -1, dtype=np.int32)
    kept = min(nodes, num_blocks)
    node_block[rng.permutation(nodes)[:kept]] = np.arange(kept, dtype=np.int32)
    block_node = np.full(num_blocks, -1, dtype=np.int32)
    block_node[node_block[node_block >= 0]] = np.flatnonzero(node_block >= 0)
    node_block = torch.from_numpy(node_block).to(dev)
    block_node = torch.from_numpy(block_node).to(dev)
    before = cuda_lib.LAUNCHES["leaf_blocks"]
    got = ep.leaf_blocks(values, block_node, kg)
    assert cuda_lib.LAUNCHES["leaf_blocks"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ep.leaf_blocks_plain(values, node_block, num_blocks))
    assert torch.equal(got.cpu(), ep.leaf_blocks(values.cpu(), block_node.cpu(), kg))
    assert torch.equal(_leaf_blocks_poisoned(values, block_node, kg, num_blocks), got)


def _leaf_blocks_poisoned(values, block_node, kg, num_blocks):
    """The kernel straight from the library into a buffer of 0xAAAAAAAA
    words, so a word it leaves unwritten shows."""
    out = torch.full((32 * kg, num_blocks, 4), -0x55555556, dtype=torch.int32,
                     device=values.device)
    err = cuda_lib.library().dpf_leaf_blocks(
        values.data_ptr(), block_node.data_ptr(), out.data_ptr(), values.shape[-1], kg,
        num_blocks, torch.cuda.current_stream(values.device).cuda_stream)
    cuda_lib.check(err, "leaf_blocks")
    return out


# The exit orders the serving paths pass, with their cached block -> node
# maps: a streaming chunk's (bit-reversed) and the level plan's
# (bit-reversed, with blocks past the tree).
@pytest.mark.parametrize("kg,levels,order,num_blocks", [
    (32, 5, "chunk", 32), (32, 10, "chunk", 1024), (4, 6, "level", 64),
    (4, 6, "level", 80), (1, 7, "level", 100)])
def test_leaf_blocks_writes_every_word_in_exit_orders(dev, kg, levels, order, num_blocks):
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
        exit_block_nodes,
        expansion_plan,
    )
    from distributed_point_functions_tpu_torch.pir.dense_eval_planes_v2 import (
        chunk_block_nodes,
    )

    if order == "chunk":
        block_node = chunk_block_nodes(levels, expansion_plan("walk", kg, levels), True)
    else:
        block_node = exit_block_nodes(levels, *expansion_plan(order, kg, levels), False,
                                      num_blocks)
    block_node = torch.from_numpy(block_node).to(dev)
    node_block = ep.node_blocks(block_node, 1 << levels)
    values = _words(np.random.default_rng(levels), (16, 8, kg << levels), dev)
    want = ep.leaf_blocks_plain(values, node_block, num_blocks)
    got = ep.leaf_blocks(values, block_node, kg)
    poisoned = _leaf_blocks_poisoned(values, block_node, kg, num_blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(poisoned, want)


def test_expand_tail_allocates_only_its_outputs(dev):
    # The main path's tail (2,048 -> 32,768 columns, 128-column tiles): the
    # launch holds no scratch beside its two outputs.
    rng = np.random.default_rng(5)
    g0, kg, r, tile = 2048, 4, 4, 128
    args = [_words(rng, s, dev) for s in
            ((16, 8, g0), (g0,), (r, 16, 8, kg), (r, kg), (r, kg), (16, 8, kg))]
    ep.expand_tail(*args, tile)  # the build, and any first-call state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = ep.expand_tail(*args, tile)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in out)
    assert torch.cuda.max_memory_allocated(dev) - base <= outputs + (64 << 10)


@pytest.mark.parametrize("tier", ["streaming", "chunked"])
def test_tiers_on_the_card_match_the_host(dev, tier):
    rng = np.random.default_rng(9)
    records = [rng.bytes(20) for _ in range(3000)]
    idx = [int(i) for i in rng.integers(0, len(records), 40)]
    reqs = DenseDpfPirClient.create(len(records), encrypt_decrypt.encrypt).create_plain_requests(idx)
    previous = set_default_capacity_model(CapacityModel(selection_budget=4096))
    server_mod.set_tier_floor(tier if tier == "chunked" else None)
    try:
        shares = {}
        for device in (dev, "cpu"):
            server = DenseDpfPirServer.create_plain(
                DenseDpfPirDatabase(records, device=device), device=device)
            assert server._plan_serving(len(idx)).mode == tier
            shares[str(device)] = [
                server.handle_plain_request(r).dpf_pir_response.masked_response
                for r in reqs]
    finally:
        set_default_capacity_model(previous)
        server_mod.clear_tier_floor()
    assert shares[str(dev)] == shares["cpu"]
    for a, b, i in zip(*shares["cpu"], idx):
        assert bytes(x ^ y for x, y in zip(a, b)) == records[i]
