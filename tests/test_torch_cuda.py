"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. The shapes are
small and deliberately ragged (one key group, widths that are not a
multiple of the block size, narrow records, query counts that are not a
multiple of 8). This file imports no JAX, so on a machine with a card and
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops import expand_planes as ep
from distributed_point_functions_tpu_torch.ops import inner_product_kernels as ipk
from distributed_point_functions_tpu_torch.ops.words import to_tensor
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(rng, shape, device):
    return to_tensor(rng.integers(0, 1 << 32, shape, dtype=np.uint32), device)


# K2 takes 4 input columns a tile (128 threads, a group of 16 a child) and
# walks the tiles grid-stride: widths below, at and past one tile, and
# 8,192 columns, past the tiles the card holds at once.
@pytest.mark.parametrize("g,kg", [(1, 1), (3, 1), (96, 3), (200, 4), (2, 2), (4, 4),
                                  (5, 1), (36, 4), (8192, 32)])
def test_expand_level_matches_plain(dev, g, kg):
    rng = np.random.default_rng(g)
    args = [_words(rng, s, dev) for s in ((16, 8, g), (g,), (16, 8, kg), (kg,), (kg,))]
    before = cuda_lib.LAUNCHES["expand_level"]
    got = ep.expand_level(*args)
    assert cuda_lib.LAUNCHES["expand_level"] == before + 1
    want = ep.expand_level_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("g,kg", [(1, 1), (100, 2)])
def test_value_hash_matches_plain(dev, g, kg):
    rng = np.random.default_rng(g + 1)
    args = [_words(rng, s, dev) for s in ((16, 8, g), (g,), (16, 8, kg))]
    got = ep.value_hash(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ep.value_hash_plain(*args))


@pytest.mark.parametrize("nq,groups,words", [(5, 128, 4), (8, 136, 33), (136, 256, 64)])
def test_xor_inner_product_matches_plain(dev, nq, groups, words):
    rng = np.random.default_rng(nq * groups)
    db_perm = _words(rng, (32, groups, words), dev)
    packed = _words(rng, (nq, groups), dev)
    got = ipk.xor_inner_product_packed(db_perm, packed)
    torch.cuda.synchronize()
    assert torch.equal(got, ipk.xor_inner_product_packed_plain(db_perm, packed))


def _fused_args(rng, g0, kg, r, device):
    return [_words(rng, s, device) for s in
            ((16, 8, g0), (g0,), (r, 16, 8, kg), (r, kg), (r, kg), (16, 8, kg))]


# (G0, KG, r, node lanes / KG, value hash): ragged small shapes, then the
# main path's two phases (head: 4 -> 2,048 columns; tail: 2,048 -> 32,768
# with the value hash).
@pytest.mark.parametrize(
    "g0,kg,r,nodes,vh",
    [(3, 1, 2, 1, True), (8, 2, 3, 2, False), (4, 4, 9, 1, False),
     (2048, 4, 4, 1, True)],
)
def test_walk_descend_matches_plain(dev, g0, kg, r, nodes, vh):
    rng = np.random.default_rng(g0 + r)
    *args, vc = _fused_args(rng, g0, kg, r, dev)
    before = cuda_lib.LAUNCHES["walk_descend"]
    got = ep.walk_descend(*args, vc, value_hash=vh, node_lanes=nodes * kg)
    assert cuda_lib.LAUNCHES["walk_descend"] == before + 1
    want = ep.walk_descend_plain(*args, vc, value_hash=vh, node_lanes=nodes * kg)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (4, 4, 9): the main path's head, 4 -> 2,048 columns; (32, 32, 6): the
# materialized tier's at 1,024 queries; (1, 1, 10): the DPF full domain's.
@pytest.mark.parametrize("g0,kg,r", [(3, 1, 1), (6, 2, 3), (4, 4, 9), (32, 32, 6),
                                     (1, 1, 10)])
def test_expand_head_matches_plain(dev, g0, kg, r):
    rng = np.random.default_rng(g0 * r)
    *args, _ = _fused_args(rng, g0, kg, r, dev)
    before = cuda_lib.LAUNCHES["expand_head"]
    got = ep.expand_head(*args)
    assert cuda_lib.LAUNCHES["expand_head"] == before + 1
    want = ep.expand_head_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (2048, 4, 4, 128) is the main path's tail: 2,048 -> 32,768 columns in
# 128-column tiles; (6, 2, 2, 4) has a narrower last tile, and so has
# (12, 2, 5, 8), whose blocks also walk one root level before doubling.
@pytest.mark.parametrize("g0,kg,r,tile", [(6, 2, 2, 4), (8, 1, 3, 1), (2048, 4, 4, 128),
                                          (12, 2, 5, 8)])
def test_expand_tail_matches_plain(dev, g0, kg, r, tile):
    rng = np.random.default_rng(g0 + tile)
    args = _fused_args(rng, g0, kg, r, dev)
    before = cuda_lib.LAUNCHES["expand_tail"]
    got = ep.expand_tail(*args, tile)
    assert cuda_lib.LAUNCHES["expand_tail"] == before + 1
    want = ep.expand_tail_plain(*args, tile)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("expansion", ["walk", "tail", "level"])
def test_dense_pir_on_the_card_matches_the_plain_server(dev, expansion):
    rng = np.random.default_rng(9)
    recs = [rng.bytes(int(n)) for n in rng.integers(1, 40, 1000)]
    idx = [int(i) for i in rng.integers(0, len(recs), 37)]
    reqs = DenseDpfPirClient.create(len(recs), encrypt_decrypt.encrypt).create_plain_requests(idx)
    card = DenseDpfPirServer.create_plain(DenseDpfPirDatabase(recs), expansion=expansion)
    host = DenseDpfPirServer.create_plain(
        DenseDpfPirDatabase(recs, device="cpu"), device="cpu", expansion=expansion
    )
    shares = []
    for req in reqs:
        a = card.handle_plain_request(req).dpf_pir_response.masked_response
        assert a == host.handle_plain_request(req).dpf_pir_response.masked_response
        shares.append(a)
    width = max(len(r) for r in recs)
    for s0, s1, i in zip(*shares, idx):
        assert bytes(x ^ y for x, y in zip(s0, s1)) == recs[i].ljust(width, b"\0")
