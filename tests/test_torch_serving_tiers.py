"""Dense PIR's serving tiers: the port against the JAX package, bit for bit.

* The capacity model counts what the port holds (keys padded to 32, the
  leaf values beside the selections); the JAX package's planner and
  split logic run on those counts give the port's plans over a grid of
  batch sizes, block counts, budgets and forced tiers.
* `leaf_blocks`' plain version equals a numpy bit transpose and scatter.
* The streaming block order equals the JAX package's; the streaming scan
  and the chunked loop equal the JAX package's
  `streaming_pir_inner_products_v2(..., ip="jnp")` and
  `chunked_pir_inner_products` on the same keys and database, in each
  expansion mode and at each split.
* End to end, a `device="cpu"` server with a pinned selection budget
  serves each tier, and its bytes equal the JAX server's with the same
  budget (set through the JAX package's own API), and the two parties'
  shares XOR to the records.

The JAX side's expansions are XLA programs that cost seconds to trace and
compile, so they run at one small geometry (2 selection blocks, 40 keys)
in exactly the shapes its own server uses, once each: the server and the
direct calls share the compiled programs. The port's splits are checked at
a wider geometry against its materialized tier, which
`test_torch_dense_pir.py` holds against the JAX package.
"""

import ast
import dataclasses
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.capacity import model as jmodel
from distributed_point_functions_tpu.dpf import CorrectionWord as JCorrectionWord
from distributed_point_functions_tpu.dpf import DpfKey as JDpfKey
from distributed_point_functions_tpu.pir import DenseDpfPirDatabase as JDatabase
from distributed_point_functions_tpu.pir import DenseDpfPirServer as JServer
from distributed_point_functions_tpu.pir import messages as jmessages
from distributed_point_functions_tpu.pir import planner as jplanner
from distributed_point_functions_tpu.pir import server as jserver_mod
from distributed_point_functions_tpu.pir.dense_eval import (
    chunked_pir_inner_products as j_chunked,
)
from distributed_point_functions_tpu.pir.dense_eval import stage_keys as j_stage_keys
from distributed_point_functions_tpu.pir.dense_eval_planes_v2 import (
    streaming_block_order as j_block_order,
)
from distributed_point_functions_tpu.pir.dense_eval_planes_v2 import (
    streaming_block_permute_records as j_permute_records,
)
from distributed_point_functions_tpu.pir.dense_eval_planes_v2 import (
    streaming_pir_inner_products_v2 as j_streaming,
)
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.capacity import model as model_mod
from distributed_point_functions_tpu_torch.capacity.model import (
    CapacityModel,
    padded_keys,
    set_default_capacity_model,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops.expand_planes import leaf_blocks
from distributed_point_functions_tpu_torch.ops.inner_product_kernels import (
    stage_db_chunks_bitmajor,
    xor_inner_product_staged,
)
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt
from distributed_point_functions_tpu_torch.pir import server as server_mod
from distributed_point_functions_tpu_torch.pir.dense_eval import (
    chunked_pir_inner_products,
    stage_keys,
)
from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
    evaluate_selection_blocks_planes,
)
from distributed_point_functions_tpu_torch.pir.dense_eval_planes_v2 import (
    streaming_block_order,
    streaming_pir_inner_products,
)
from distributed_point_functions_tpu_torch.pir.planner import plan_dense_serving

MODES = ("walk", "tail", "level")
NUM_QUERIES = 40  # two key groups after padding to 32
# Below the materialized tier's 40 x 2 x 16 = 1,280 bytes at the small
# geometry: streaming at cut 1, chunk 0; chunked at 0 expansion levels.
PINNED_BUDGET = 1000
JAX_ENV = ("DPF_TPU_STREAMING", "DPF_TPU_STREAMING_IP",
           "DPF_TPU_SELECTION_BYTES_BUDGET", "DPF_TPU_DEVICE_MEMORY_BYTES",
           "DPF_TPU_EXPANSION")


def _jax_key(k):
    return JDpfKey(
        seed=k.seed, party=k.party,
        correction_words=[JCorrectionWord(cw.seed, cw.control_left, cw.control_right)
                          for cw in k.correction_words],
        last_level_value_correction=list(k.last_level_value_correction),
    )


def _responses(server, reqs):
    return [server.handle_plain_request(r).dpf_pir_response.masked_response
            for r in reqs]


def _reconstructs(shares, idx, records):
    return all(bytes(x ^ y for x, y in zip(a, b)) == records[i]
               for a, b, i in zip(*shares, idx))


@pytest.fixture
def pinned_budget():
    """The port's process-wide capacity model pinned to PINNED_BUDGET,
    and no tier floor; both restored after the test."""
    previous = set_default_capacity_model(CapacityModel(selection_budget=PINNED_BUDGET))
    yield
    set_default_capacity_model(previous)
    server_mod.clear_tier_floor()


# -- the capacity model and the planner -------------------------------------

MEMORIES = (16 << 30, 80 << 30)
BUDGETS = (None, PINNED_BUDGET, 64 << 20, 1 << 30)


class _PortBytes(jmodel.CapacityModel):
    """The JAX model with the port's byte counts: keys padded to 32, and
    the leaf values counted beside the selections where the port holds
    both (materialized, chunked; streaming's double buffer already does),
    the materialized tier's over `leaf_blocks` (the covering subtree's
    leaves where they outnumber the blocks; set per geometry). The JAX
    package's own split and plan logic then runs on them."""

    leaf_blocks = None

    def materialized_selection_bytes(self, num_keys, eff_blocks):
        leaves = eff_blocks if self.leaf_blocks is None else self.leaf_blocks
        return super().materialized_selection_bytes(padded_keys(num_keys), eff_blocks + leaves)

    def streaming_selection_bytes(self, num_keys, cut_levels, chunk_levels):
        return super().streaming_selection_bytes(
            padded_keys(num_keys), cut_levels, chunk_levels)

    def chunked_selection_bytes(self, num_keys, chunk_expand_levels):
        return 2 * super().chunked_selection_bytes(
            padded_keys(num_keys), chunk_expand_levels)


@pytest.fixture
def port_model(monkeypatch):
    """make(memory, budget) -> the port's CapacityModel on a card of
    `memory` bytes, set as the process-wide model (restored after the
    test), and the JAX `_PortBytes` model of the same card and budget."""
    for name in JAX_ENV:
        monkeypatch.delenv(name, raising=False)
    previous = set_default_capacity_model(None)

    def make(memory, budget):
        monkeypatch.setattr(model_mod, "probe_device_memory", lambda: memory)
        ours = CapacityModel(selection_budget=budget)
        set_default_capacity_model(ours)
        return ours, _PortBytes(device_memory_bytes=memory, selection_budget=budget)

    yield make
    set_default_capacity_model(previous)


@pytest.mark.parametrize("memory,budget", list(itertools.product(MEMORIES, (None, 64 << 20))))
def test_capacity_model_matches_jax(port_model, memory, budget):
    ours, theirs = port_model(memory, budget)
    assert ours.selection_budget_bytes() == theirs.selection_budget_bytes()
    for nk, levels in itertools.product((1, 40, 1024), (0, 1, 5, 15)):
        for a in range(levels + 1):
            assert (ours.streaming_selection_bytes(nk, a, levels - a)
                    == theirs.streaming_selection_bytes(nk, a, levels - a))
        assert (ours.materialized_selection_bytes(nk, 1 << levels)
                == theirs.materialized_selection_bytes(nk, 1 << levels))
        assert (ours.chunked_selection_bytes(nk, levels)
                == theirs.chunked_selection_bytes(nk, levels))
        assert ours.pick_streaming_split(nk, levels) == theirs.pick_streaming_split(nk, levels)
        assert (ours.pick_chunked_expand_levels(nk, levels, 10)
                == theirs.pick_chunked_expand_levels(nk, levels, 10))


@pytest.mark.parametrize("tier", server_mod.TIERS)
def test_capacity_model_counts_leaf_values_and_selections(tier):
    """40 keys run as 64; 16 bytes per block in each buffer."""
    model, jax_model = CapacityModel(), jmodel.CapacityModel(device_memory_bytes=80 << 30)
    if tier == "materialized":
        assert model.materialized_selection_bytes(40, 12) == 2 * 64 * 12 * 16
        assert model.materialized_selection_bytes(40, 12) == (
            2 * jax_model.materialized_selection_bytes(64, 12))
    elif tier == "streaming":
        assert model.streaming_selection_bytes(40, 2, 3) == 64 * 16 * (4 + 2 * 8)
        assert model.streaming_selection_bytes(40, 2, 3) == (
            jax_model.streaming_selection_bytes(64, 2, 3))
    else:
        assert model.chunked_selection_bytes(40, 3) == 2 * 64 * 8 * 16
        assert model.chunked_selection_bytes(40, 3) == (
            2 * jax_model.chunked_selection_bytes(64, 3))


def test_capacity_model_default_budget_on_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU's budget")
    assert CapacityModel().selection_budget_bytes() == 1 << 30
    monkeypatch.setattr(model_mod, "probe_device_memory", lambda: 80 << 30)
    assert CapacityModel().selection_budget_bytes() == 5 << 30


# (num_keys, num_blocks, expand_levels): BASELINE configs[1] and [2], the
# small geometries below, and a tree that does not cover its blocks.
GEOMETRIES = [(128, 8192, 13), (1024, 32768, 15), (40, 2, 1), (40, 12, 4),
              (1, 1, 0), (3, 100, 7), (40, 300, 8), (1024, 32768, 12)]


@pytest.mark.parametrize("num_keys,num_blocks,expand_levels", GEOMETRIES)
def test_planner_matches_jax(port_model, num_keys, num_blocks, expand_levels):
    fields = [f.name for f in dataclasses.fields(port.pir.planner.ServingPlan)]
    for budget, force in itertools.product(BUDGETS, (None, "streaming", "chunked")):
        _, theirs = port_model(80 << 30, budget)
        theirs.leaf_blocks = max(num_blocks, 1 << expand_levels)
        kw = dict(num_keys=num_keys, num_blocks=num_blocks, expand_levels=expand_levels,
                  force_mode=force)
        a = plan_dense_serving(**kw)
        b = jplanner.plan_dense_serving(model=theirs, backend="cpu", **kw)
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields], kw


def test_configs2_plans_at_64_mib(port_model):
    port_model(80 << 30, 64 << 20)
    kw = dict(num_keys=1024, num_blocks=32768, expand_levels=15)
    streaming = plan_dense_serving(**kw)
    assert (streaming.mode, streaming.cut_levels, streaming.chunk_levels,
            streaming.num_chunks) == ("streaming", 5, 10, 32)
    chunked = plan_dense_serving(force_mode="chunked", **kw)
    assert (chunked.mode, chunked.cut_levels, chunked.chunk_levels,
            chunked.num_chunks) == ("chunked", 5, 10, 32)
    port_model(80 << 30, None)
    assert plan_dense_serving(**kw).mode == "materialized"


def test_tier_floor_api(pinned_budget):
    assert server_mod.tier_floor() == "materialized"
    server_mod.set_tier_floor("chunked")
    assert server_mod.tier_floor() == "chunked"
    server_mod.clear_tier_floor()
    assert server_mod.tier_floor() == "materialized"
    with pytest.raises(ValueError):
        server_mod.set_tier_floor("bitplane")
    with pytest.raises(ValueError):
        plan_dense_serving(num_keys=1, num_blocks=1, expand_levels=0, force_mode="jnp")


def _leaf_blocks_numpy(planes, node_block, num_blocks):
    """Bit t of limb l of key 32 g + i in block node_block[n] = bit i of
    plane 32 l + t at column n * KG + g; blocks no node holds are zero."""
    nodes = node_block.shape[0]
    kg = planes.shape[-1] // nodes
    bits = (planes.reshape(4, 32, nodes, kg)[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    limbs = (bits << np.arange(32, dtype=np.uint32)[None, :, None, None, None]).sum(
        axis=1, dtype=np.uint32)  # [limb, node, group, lane]
    limbs = limbs.transpose(2, 3, 1, 0).reshape(32 * kg, nodes, 4)
    out = np.zeros((32 * kg, num_blocks, 4), dtype=np.uint32)
    kept = node_block >= 0
    out[:, node_block[kept]] = limbs[:, kept]
    return out


@pytest.mark.parametrize("kg,nodes,num_blocks", [(1, 4, 4), (2, 8, 5), (3, 4, 6)])
def test_leaf_blocks_matches_numpy(kg, nodes, num_blocks):
    rng = np.random.default_rng(kg * 100 + nodes)
    planes = rng.integers(0, 1 << 32, (128, kg * nodes), dtype=np.uint32)
    node_block = np.full(nodes, -1, dtype=np.int32)
    kept = min(nodes, num_blocks)
    node_block[rng.permutation(nodes)[:kept]] = np.arange(kept, dtype=np.int32)
    block_node = np.full(num_blocks, -1, dtype=np.int32)
    block_node[node_block[node_block >= 0]] = np.flatnonzero(node_block >= 0)
    cuda_lib.reset_launch_counts()
    got = leaf_blocks(to_tensor(planes.reshape(16, 8, -1), "cpu"),
                      torch.from_numpy(block_node), kg)
    assert cuda_lib.LAUNCHES["leaf_blocks"] == 0
    assert np.array_equal(to_numpy(got).view(np.uint32),
                          _leaf_blocks_numpy(planes, node_block, num_blocks))


@pytest.mark.parametrize("expand_levels,cut_levels",
                         [(0, 0), (3, 0), (3, 2), (3, 3), (6, 2)])
def test_streaming_block_order_matches_jax(expand_levels, cut_levels):
    ours = streaming_block_order(expand_levels, cut_levels)
    assert np.array_equal(ours, j_block_order(expand_levels, cut_levels))
    assert np.array_equal(ours[ours], np.arange(1 << expand_levels))  # an involution


# -- against the JAX package at a small geometry ----------------------------

@pytest.fixture(scope="module")
def small():
    """200 records of 12 bytes (2 selection blocks, 1 expansion level), 40
    queries; the JAX server's responses with the pinned budget (streaming
    at cut 1) and with the chunked tier floor, and the JAX package's
    streaming and chunked functions on party 0's staged keys."""
    rng = np.random.default_rng(2404)
    records = [rng.bytes(12) for _ in range(200)]
    idx = [int(i) for i in rng.integers(0, len(records), NUM_QUERIES)]
    reqs = DenseDpfPirClient.create(len(records), encrypt_decrypt.encrypt).create_plain_requests(idx)
    jreqs = [jmessages.PirRequest(plain_request=jmessages.PlainRequest(
        dpf_keys=[_jax_key(k) for k in r.plain_request.dpf_keys])) for r in reqs]
    with pytest.MonkeyPatch.context() as mp:
        for name in JAX_ENV:
            mp.delenv(name, raising=False)
        mp.setenv("DPF_TPU_DONATE", "0")  # the chunked loop's plain jit
        previous = jmodel.set_default_capacity_model(
            jmodel.CapacityModel(device_memory_bytes=80 << 30,
                                 selection_budget=PINNED_BUDGET))
        try:
            builder = JDatabase.Builder()
            for r in records:
                builder.insert(r)
            jdb = builder.build()
            jserver = JServer.create_plain(jdb)
            plan = jserver._plan_serving(NUM_QUERIES, False)
            assert (plan.mode, plan.cut_levels, plan.chunk_levels) == ("streaming", 1, 0)
            streaming = _responses(jserver, jreqs)
            jserver_mod.set_tier_floor("chunked")
            try:
                chunked = _responses(jserver, jreqs)
            finally:
                jserver_mod.clear_tier_floor()
            # The staged shapes and arguments of the JAX server's own calls.
            keys, walk = jreqs[0].plain_request.dpf_keys, jserver._walk_levels
            j_stream = np.asarray(j_streaming(
                *j_stage_keys(keys, host_walk_levels=walk),
                jdb.streaming_chunks(cut_levels=1, bitmajor=False),
                walk_levels=0, cut_levels=1, chunk_levels=0, ip="jnp"))
            padded_blocks, db = jserver._chunked_database()
            j_chunk = np.asarray(j_chunked(
                *j_stage_keys(keys), db, walk_levels=walk, chunk_bits=1,
                chunk_expand_levels=0, num_chunks=padded_blocks))
        finally:
            jmodel.set_default_capacity_model(previous)
    return dict(records=records, idx=idx, reqs=reqs, streaming=streaming,
                chunked=chunked, j_stream=j_stream, j_chunk=j_chunk, walk=walk,
                db=DenseDpfPirDatabase(records, device="cpu"))


def _staged(small):
    """Party 0's keys staged at the covering subtree's root."""
    return stage_keys(small["reqs"][0].plain_request.dpf_keys, small["walk"],
                      device="cpu")


def test_jax_tiers_agree(small):
    assert small["streaming"] == small["chunked"]
    assert _reconstructs(small["streaming"], small["idx"], small["records"])
    assert np.array_equal(small["j_stream"], small["j_chunk"])


@pytest.mark.parametrize("mode,cut", list(itertools.product(MODES, (0, 1))))
def test_streaming_matches_jax(small, mode, cut):
    out = streaming_pir_inner_products(
        *_staged(small), small["db"].streaming_chunks(cut), cut_levels=cut,
        chunk_levels=1 - cut, mode=mode)
    assert np.array_equal(to_numpy(out), small["j_stream"])


@pytest.mark.parametrize("mode,bits", list(itertools.product(MODES, (0, 1))))
def test_chunked_matches_jax(small, mode, bits):
    db = small["db"].chunked_staging(2)
    out = chunked_pir_inner_products(
        *_staged(small), db, chunk_bits=bits, chunk_expand_levels=1 - bits,
        num_chunks=1 << bits, mode=mode)
    assert np.array_equal(to_numpy(out), small["j_chunk"])


@pytest.mark.parametrize("mode,tier", list(itertools.product(MODES, server_mod.TIERS)))
def test_server_tiers_match_jax(small, pinned_budget, mode, tier):
    if tier == "materialized":
        set_default_capacity_model(None)  # the CPU's 1 GiB budget
    if tier == "chunked":
        server_mod.set_tier_floor("chunked")
    server = DenseDpfPirServer.create_plain(small["db"], device="cpu", expansion=mode)
    assert server._plan_serving(NUM_QUERIES).mode == tier
    cuda_lib.reset_launch_counts()
    ours = _responses(server, small["reqs"])
    assert not any(cuda_lib.LAUNCHES.values()), cuda_lib.LAUNCHES
    assert ours == (small["chunked"] if tier == "chunked" else small["streaming"])
    assert _reconstructs(ours, small["idx"], small["records"])


# -- the port's splits at a wider geometry ----------------------------------

@pytest.fixture(scope="module")
def wide():
    """1,500 records of 8 bytes (12 selection blocks, a 4-level tree over
    16), 40 queries; party 0's staged keys and its materialized result."""
    rng = np.random.default_rng(1500)
    records = [rng.bytes(8) for _ in range(1500)]
    reqs = DenseDpfPirClient.create(len(records), encrypt_decrypt.encrypt).create_plain_requests(
        [int(i) for i in rng.integers(0, len(records), NUM_QUERIES)])
    db = DenseDpfPirDatabase(records, device="cpu")
    walk = DenseDpfPirServer(db, device="cpu").walk_levels
    staged = stage_keys(reqs[0].plain_request.dpf_keys, walk, device="cpu")
    selections = evaluate_selection_blocks_planes(
        *staged, expand_levels=4, num_blocks=db.num_selection_blocks)
    return dict(db=db, staged=staged,
                want=to_numpy(xor_inner_product_staged(db.staged(), selections)))


@pytest.mark.parametrize("mode,cut", [("walk", 0), ("walk", 2), ("walk", 4),
                                      ("tail", 1), ("level", 3)])
def test_streaming_splits_match_materialized(wide, mode, cut):
    out = streaming_pir_inner_products(
        *wide["staged"], wide["db"].streaming_chunks(cut), cut_levels=cut,
        chunk_levels=4 - cut, mode=mode)
    assert np.array_equal(to_numpy(out), wide["want"])


@pytest.mark.parametrize("mode,bits", [("walk", 2), ("tail", 0), ("level", 3)])
def test_chunked_splits_match_materialized(wide, mode, bits):
    out = chunked_pir_inner_products(
        *wide["staged"], wide["db"].chunked_staging(16), chunk_bits=bits,
        chunk_expand_levels=4 - bits, num_chunks=1 << bits, mode=mode)
    assert np.array_equal(to_numpy(out), wide["want"])


@pytest.mark.parametrize("cut", [0, 2])
def test_streaming_staging_matches_jax_block_order(wide, cut):
    rows = to_numpy(wide["db"].db_words)
    rows = np.concatenate([rows, np.zeros((2048 - rows.shape[0], rows.shape[1]),
                                          rows.dtype)])
    want = stage_db_chunks_bitmajor(
        to_tensor(j_permute_records(rows, cut), "cpu"), 1 << cut)
    assert torch.equal(wide["db"].streaming_chunks(cut), want)


def test_chunked_staging_pads_to_the_granule(wide):
    db = wide["db"]
    assert db.chunked_staging(16) is db.staged()  # 4,096 staged records cover 16 blocks
    padded = db.chunked_staging(64)
    assert padded.shape[1] == 256 and torch.equal(padded[:, :128], db.staged())
    assert not padded[:, 128:].any()


@pytest.mark.parametrize(
    "module", ["capacity/model.py", "pir/planner.py", "pir/dense_eval_planes_v2.py",
               "pir/dense_eval.py"])
def test_new_serving_modules_have_no_try(module):
    tree = ast.parse((Path(port.__file__).parent / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
