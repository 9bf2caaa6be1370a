"""Dense PIR end to end: the port against the JAX package, bit for bit.

Keys, staged arrays and the expansion are compared on the same inputs;
end to end, on a 2^12 x 32 B database with 40 queries, the port's plain
server (CPU, plain kernel versions) must return each party's
`masked_response` bytes exactly as the JAX server does, in each of the
port's expansion modes (walk, tail, level) and across head/tail splits.
The JAX side
serves through its plane expansion (`DPF_TPU_EXPANSION=planes`), which on
the CPU is the XLA per-level path, so it compiles one program for both
the expansion check and the server.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_point_functions_tpu.dpf import DistributedPointFunction as JDpf
from distributed_point_functions_tpu.dpf import DpfParameters as JParams
from distributed_point_functions_tpu.pir import DenseDpfPirDatabase as JDatabase
from distributed_point_functions_tpu.pir import DenseDpfPirServer as JServer
from distributed_point_functions_tpu.pir import messages as jmessages
from distributed_point_functions_tpu.pir.dense_eval import stage_keys_host as j_stage
from distributed_point_functions_tpu.pir.dense_eval_planes import (
    evaluate_selection_blocks_planes as j_eval_planes,
)
from distributed_point_functions_tpu.value_types import XorType as JXor
from distributed_point_functions_tpu_torch import interop
from distributed_point_functions_tpu_torch.dpf import DistributedPointFunction, DpfParameters
from distributed_point_functions_tpu_torch.ops.words import to_numpy, to_tensor
from distributed_point_functions_tpu_torch.pir import (
    DenseDpfPirClient,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
)
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt
from distributed_point_functions_tpu_torch.pir import messages
from distributed_point_functions_tpu_torch.pir.dense_eval import stage_keys_host
from distributed_point_functions_tpu_torch.pir.dense_eval_planes import (
    evaluate_planned,
    evaluate_selection_blocks_planes,
    expansion_plan,
)
from distributed_point_functions_tpu_torch.value_types import XorType

NUM_RECORDS = 1 << 12
RECORD_BYTES = 32
NUM_QUERIES = 40


def _key_fields(k):
    return (
        k.seed,
        k.party,
        [(cw.seed, cw.control_left, cw.control_right) for cw in k.correction_words],
        [int(v) for v in k.last_level_value_correction],
    )


@pytest.fixture(scope="module")
def case():
    """One database, one batch of query keys (made by the port's client),
    the JAX server's responses and the JAX expansion of the staged keys."""
    rng = np.random.default_rng(1212)
    records = [rng.bytes(RECORD_BYTES) for _ in range(NUM_RECORDS)]
    idx = [int(i) for i in rng.integers(0, NUM_RECORDS, NUM_QUERIES)]
    reqs = DenseDpfPirClient.create(NUM_RECORDS, encrypt_decrypt.encrypt).create_plain_requests(idx)
    jdb = JDatabase.Builder()
    for r in records:
        jdb.insert(r)
    jserver = JServer.create_plain(jdb.build())
    walk, expand = jserver._walk_levels, jserver._expand_levels
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPF_TPU_EXPANSION", "planes")
        mp.setenv("DPF_TPU_HOST_WALK", "1")
        jkeys = [
            [_to_jax_key(k) for k in r.plain_request.dpf_keys] for r in reqs
        ]
        staged = [j_stage(keys, walk) for keys in jkeys]
        jsel = np.asarray(
            j_eval_planes(
                *[jnp.asarray(a) for a in staged[0]],
                walk_levels=0,
                expand_levels=expand,
                num_blocks=jserver._num_blocks,
                force_planes=True,
            )
        )
        jresp = [
            jserver.handle_plain_request(
                jmessages.PirRequest(plain_request=jmessages.PlainRequest(dpf_keys=keys))
            ).dpf_pir_response.masked_response
            for keys in jkeys
        ]
    return dict(records=records, idx=idx, reqs=reqs, staged=staged,
                jsel=jsel, jresp=jresp, walk=walk, expand=expand,
                num_blocks=jserver._num_blocks)


def _to_jax_key(k):
    from distributed_point_functions_tpu.dpf import CorrectionWord, DpfKey

    return DpfKey(
        seed=k.seed,
        party=k.party,
        correction_words=[
            CorrectionWord(cw.seed, cw.control_left, cw.control_right)
            for cw in k.correction_words
        ],
        last_level_value_correction=list(k.last_level_value_correction),
    )


@pytest.mark.parametrize("log_domain", [5, 20])
def test_generate_keys_batch_matches_jax(log_domain):
    rng = np.random.default_rng(log_domain)
    n = 6
    roots = rng.integers(0, 1 << 32, (2, n, 4), dtype=np.uint32)
    alphas = [int(a) for a in rng.integers(0, 1 << log_domain, n)]
    betas = [1 << int(b) for b in rng.integers(0, 128, n)]
    ours = DistributedPointFunction.create(
        DpfParameters(log_domain, XorType(128))
    ).generate_keys_batch(alphas, betas, _root_seeds=roots)
    theirs = JDpf.create(JParams(log_domain, JXor(128))).generate_keys_batch(
        alphas, betas, _root_seeds=roots
    )
    for party in (0, 1):
        assert [_key_fields(k) for k in ours[party]] == [
            _key_fields(k) for k in theirs[party]
        ]


def test_keys_from_arrays_round_trips_jax_keys(case):
    reqs = case["reqs"]
    for party, req in enumerate(reqs):
        jkeys = [_to_jax_key(k) for k in req.plain_request.dpf_keys]
        arrays = j_stage(jkeys, 0)
        back = interop.keys_from_arrays(*arrays, party=party)
        assert [_key_fields(k) for k in back] == [_key_fields(k) for k in jkeys]
    with pytest.raises(ValueError):
        interop.keys_from_arrays(*j_stage(jkeys, 0), party=0)


def test_stage_keys_host_matches_jax(case):
    for req, jstaged in zip(case["reqs"], case["staged"]):
        ours = stage_keys_host(req.plain_request.dpf_keys, case["walk"])
        for a, b in zip(ours, jstaged):
            assert np.array_equal(a, b)


def test_expansion_matches_jax_on_staged_arrays(case):
    sel = evaluate_selection_blocks_planes(
        *(to_tensor(a, "cpu") for a in case["staged"][0]),
        expand_levels=case["expand"],
        num_blocks=case["num_blocks"],
    )
    assert sel.shape == case["jsel"].shape
    assert np.array_equal(to_numpy(sel), case["jsel"])


# (mode, head_levels, tail_levels, tail_tile_lanes) at this case's 40 keys
# (KG = 2 after padding) and 5 levels; the plan each gives is in the id.
SPLITS = [
    ("walk", None, None, None),  # K2 x1, K4 tail x4
    ("walk", 2, 1, None),  # K4 head x2, K2 x2, K4 tail x1
    ("walk", None, 0, None),  # K4 head x5, K3
    ("walk", 0, 0, None),  # K2 x5, K3
    ("tail", None, None, None),  # K6 head x4, K5 tail x1 (16-node tiles)
    ("tail", 0, 4, 2),  # K5 tail x4, one-node tiles
    ("tail", 2, 1, None),  # K6 head x2, K2 x2, K5 tail x1
    ("tail", 0, 0, None),  # K2 x5, K3
    ("level", None, None, None),  # K2 x5, K3
    ("level", 2, None, None),  # K6 head x2, K2 x3, K3
]


@pytest.mark.parametrize(
    "mode,head,tail,tile", SPLITS,
    ids=[f"{m}-h{h}-t{t}-l{l}" for m, h, t, l in SPLITS],
)
def test_expansion_modes_and_splits_match_jax(case, mode, head, tail, tile):
    plan = expansion_plan(mode, 2, case["expand"], head_levels=head,
                          tail_levels=tail, tail_tile_lanes=tile)
    sel = evaluate_planned(
        *(to_tensor(a, "cpu") for a in case["staged"][0]),
        expand_levels=case["expand"], num_blocks=case["num_blocks"], mode=mode,
        plan=plan,
    )
    assert np.array_equal(to_numpy(sel), case["jsel"])


@pytest.mark.parametrize("mode", ["walk", "tail", "level"])
def test_expansion_cuts_and_pads_the_blocks(case, mode):
    # Fewer blocks than leaves cuts the exit gather; more pads with zeros.
    staged = [to_tensor(a, "cpu") for a in case["staged"][0]]
    for n in (20, 36):
        sel = to_numpy(evaluate_selection_blocks_planes(
            *staged, expand_levels=case["expand"], num_blocks=n, mode=mode))
        assert np.array_equal(sel[:, :32], case["jsel"][:, :n])
        assert not sel[:, 32:].any()


@pytest.mark.parametrize("expansion", ["walk", "tail", "level"])
def test_end_to_end_masked_responses_match_jax(case, expansion):
    db = interop.database_from_records(case["records"], device="cpu")
    server = DenseDpfPirServer.create_plain(db, device="cpu", expansion=expansion)
    ours = [
        server.handle_plain_request(r).dpf_pir_response.masked_response
        for r in case["reqs"]
    ]
    for party in (0, 1):
        assert ours[party] == case["jresp"][party]
    for s0, s1, i in zip(ours[0], ours[1], case["idx"]):
        assert bytes(a ^ b for a, b in zip(s0, s1)) == case["records"][i]


@pytest.mark.parametrize("size", [1, 100, 129, 1000])
def test_plain_server_reconstructs_small_databases(size):
    # Depths the 2^12 case does not reach: no expansion level (one
    # selection block), no walk (a one-record domain), ragged blocks.
    rng = np.random.default_rng(size)
    recs = [rng.bytes(7) for _ in range(size)]
    server = DenseDpfPirServer.create_plain(
        DenseDpfPirDatabase(recs, device="cpu"), device="cpu"
    )
    idx = [0, size - 1, size // 2]
    r0, r1 = DenseDpfPirClient.create(size, encrypt_decrypt.encrypt).create_plain_requests(idx)
    s0 = server.handle_plain_request(r0).dpf_pir_response.masked_response
    s1 = server.handle_plain_request(r1).dpf_pir_response.masked_response
    for a, b, i in zip(s0, s1, idx):
        assert bytes(x ^ y for x, y in zip(a, b)) == recs[i]


def test_server_validates_requests():
    db = DenseDpfPirDatabase([b"abc"] * 300, device="cpu")
    server = DenseDpfPirServer.create_plain(db, device="cpu")
    with pytest.raises(ValueError):
        server.handle_plain_request(messages.PirRequest())
    with pytest.raises(ValueError):
        server.handle_plain_request(
            messages.PirRequest(plain_request=messages.PlainRequest(dpf_keys=[]))
        )
    keys, _ = DenseDpfPirClient.create(300, encrypt_decrypt.encrypt).create_plain_requests([1])
    bad = dataclasses.replace(keys.plain_request.dpf_keys[0], party=2)
    with pytest.raises(ValueError):
        server.handle_plain_request(
            messages.PirRequest(plain_request=messages.PlainRequest(dpf_keys=[bad]))
        )


def test_database_layout_and_variable_records():
    recs = [b"a" * 5, b"", b"xyz" * 4]
    db = DenseDpfPirDatabase(recs, device="cpu")
    assert (db.size, db.max_value_size, db.num_selection_blocks) == (3, 12, 1)
    words = to_numpy(db.db_words)
    assert words.shape == (128, 3)
    raw = words.astype("<u4").view(np.uint8)
    for i, r in enumerate(recs):
        assert raw[i, : len(r)].tobytes() == r
        assert not raw[i, len(r):].any()
    assert not raw[3:].any()
