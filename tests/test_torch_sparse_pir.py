"""Sparse PIR of the port (`pir/cuckoo_database.py`, `pir/sparse_server.py`,
`pir/sparse_client.py`) against the JAX package's, on the CPU.

* The native cuckoo build's slot array equals the JAX package's native
  one for the same keys, seeds and `rng_seed`, and its bucket indices the
  SHA256 family's.
* `PirServerPublicParams` bytes equal the JAX package's protobuf bytes and
  parse back.
* At 60 keys (90 buckets, one selection block) and 3,000 keys (4,500
  buckets, 36 blocks: a ragged covering tree of 64), the port's sparse
  server on the JAX database's exact layout (`interop.cuckoo_database_from_fields`)
  answers a JAX client's plain requests with the JAX sparse server's bytes,
  in every expansion mode and on every serving tier; the port's own
  builder gives the same layout.
* The Leader/Helper round trip with the port's client, and a JAX client's
  encrypted request carried over the wire; `create_from_public_params` on
  bytes; absent keys resolve to `KeyNotFound`; empty values, ragged value
  lengths and one long key.

Every JAX request of the file has `QUERIES` queries at one of two bucket
counts, so the JAX sparse server compiles its expansion once per database
size (the 3,000-key program is most of this file's time).
"""

import numpy as np
import pytest

from distributed_point_functions_tpu import native as jnative
from distributed_point_functions_tpu import serialization as jser
from distributed_point_functions_tpu.hashing import HashFamilyConfig as JConfig
from distributed_point_functions_tpu.pir import (
    CuckooHashedDpfPirDatabase as JDatabase,
    CuckooHashingSparseDpfPirClient as JClient,
    CuckooHashingSparseDpfPirServer as JServer,
)
from distributed_point_functions_tpu.pir.cuckoo_database import (
    CuckooHashingParams as JParams,
)
from distributed_point_functions_tpu.pir.dense_eval import (
    selection_blocks_for_keys as j_selection_blocks,
)
from distributed_point_functions_tpu.protos import pir_pb2
from distributed_point_functions_tpu.testing import encrypt_decrypt as jed
from distributed_point_functions_tpu_torch import interop, native, serialization
from distributed_point_functions_tpu_torch.hashing import (
    HashFamilyConfig,
    sha256_hash_function,
)
from distributed_point_functions_tpu_torch.ops import cuda_lib
from distributed_point_functions_tpu_torch.ops.words import to_numpy
from distributed_point_functions_tpu_torch.pir import (
    CuckooHashedDpfPirDatabase,
    CuckooHashingParams,
    CuckooHashingSparseDpfPirClient,
    CuckooHashingSparseDpfPirServer,
    DenseDpfPirDatabase,
    DenseDpfPirServer,
    KeyNotFound,
)
from distributed_point_functions_tpu_torch.pir import server as server_mod
from distributed_point_functions_tpu_torch.pir.cuckoo_database import cuckoo_slots
from distributed_point_functions_tpu_torch.pir.database import records_to_rows
from distributed_point_functions_tpu_torch.pir.dense_eval import selection_blocks_for_keys
from distributed_point_functions_tpu_torch.pir.dense_eval_planes import EXPANSION_MODES
from distributed_point_functions_tpu_torch.testing import encrypt_decrypt

SEED = b"0123456789abcdef"
QUERIES = 8  # 24 keys a request, in every JAX request of the file


def _records(n, rng, kind):
    """n (key, value) pairs. "plain": keys "key<i>" (ragged lengths), 16-byte
    values; "edges": ragged values 0-30 bytes with some empty, and one
    100-byte key."""
    if kind == "plain":
        return {b"key%d" % i: rng.bytes(16) for i in range(n)}
    out = {b"e%d" % i: rng.bytes(int(rng.integers(0, 31))) for i in range(n - 1)}
    for k in list(out)[::7]:
        out[k] = b""
    out[b"L" * 100] = rng.bytes(9)
    return out


def _jax_db(records):
    params = JServer.generate_params(len(records), seed=SEED)
    builder = JDatabase.Builder().set_params(params)
    for kv in records.items():
        builder.insert(kv)
    return params, builder.build()


def _queries(records, rng):
    keys = list(records)
    picked = [keys[int(i)] for i in rng.choice(len(keys), QUERIES - 2, replace=False)]
    return picked[:3] + [b"absent-1"] + picked[3:] + [b"key-not-here"]


def _port_request(dpf, jrequest, jdpf):
    """A JAX request carried over the wire to the port."""
    wire = jser.pir_request_to_proto(jdpf, jrequest).SerializeToString()
    return serialization.parse_pir_request(dpf, wire)


class Case:
    """One database: the JAX database, server and client, the port's
    database on the JAX layout, a JAX client's plain requests and the JAX
    server's responses to them."""

    def __init__(self, n, kind, seed):
        rng = np.random.default_rng(seed)
        self.records = _records(n, rng, kind)
        self.params, self.jdb = _jax_db(self.records)
        self.jserver = JServer.create_plain(self.params, self.jdb)
        self.jclient = JClient.create(self.params, jed.encrypt)
        self.db = interop.cuckoo_database_from_fields(
            self.params.num_buckets, self.params.num_hash_functions,
            self.params.hash_family_config.hash_family,
            self.params.hash_family_config.seed, self.jdb.slots, self.records,
            device="cpu")
        self.queries = _queries(self.records, rng)
        self.jrequests = self.jclient.create_plain_requests(self.queries)
        self.want = [self.jserver.handle_request(r).dpf_pir_response.masked_response
                     for r in self.jrequests]

    def serve(self, server):
        return [server.handle_request(_port_request(
            server.dpf, r, self.jserver.dpf)).dpf_pir_response.masked_response
            for r in self.jrequests]


@pytest.fixture(scope="module")
def small():
    return Case(60, "plain", 60)


@pytest.fixture(scope="module")
def ragged():
    return Case(3000, "plain", 3000)


@pytest.fixture(scope="module")
def edges():
    return Case(60, "edges", 61)


# -- the native build and the wire format -------------------------------------------


@pytest.mark.parametrize("n,buckets,rng_seed", [(60, 90, 0x5EED), (3000, 4500, 0x5EED),
                                                 (3000, 4500, 7), (500, 600, 0x5EED)])
def test_native_cuckoo_build_equals_jax(n, buckets, rng_seed):
    rng = np.random.default_rng(n + buckets)
    keys = [rng.bytes(int(rng.integers(1, 24))) for _ in range(n)]
    seeds = [SEED + str(i).encode() for i in range(3)]
    got = native.cuckoo_build(keys, seeds, buckets, max(128, n), rng_seed=rng_seed)
    want = jnative.cuckoo_build(keys, seeds, buckets, max(128, n), rng_seed=rng_seed)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    placed = got[got >= 0]
    assert sorted(placed.tolist()) == list(range(n))
    buckets_of = native.cuckoo_hash_buckets(keys, seeds, buckets)
    fns = [sha256_hash_function(s) for s in seeds]
    assert buckets_of.tolist() == [[f(k, buckets) for f in fns] for k in keys]
    assert all(b in buckets_of[k] for b, k in enumerate(got) if k >= 0)


def test_native_cuckoo_build_fails_as_jax():
    keys = [b"k%d" % i for i in range(40)]
    seeds = [b"s0", b"s1"]
    with pytest.raises(RuntimeError, match="relocation budget exhausted"):
        jnative.cuckoo_build(keys, seeds, 30, 8)
    with pytest.raises(RuntimeError, match="relocation budget exhausted"):
        native.cuckoo_build(keys, seeds, 30, 8)
    with pytest.raises(ValueError, match="rejected"):
        native.cuckoo_build(keys, seeds[:1], 30, 8)


PUBLIC_PARAMS = [None, (0, 0, 0, b""), (90, 3, 1, SEED), (25165824, 3, 1, b"x" * 40),
                 (-5, -1, 7, b"\x00")]


@pytest.mark.parametrize("fields", PUBLIC_PARAMS)
def test_public_params_bytes_equal_jax(fields):
    if fields is None:
        jparams = params = None
    else:
        nb, nh, fam, seed = fields
        jparams = JParams(nb, nh, JConfig(fam, seed))
        params = CuckooHashingParams(nb, nh, HashFamilyConfig(fam, seed))
    want = jser.public_params_to_proto(jparams).SerializeToString()
    assert serialization.serialize_public_params(params) == want
    assert serialization.parse_public_params(want) == params


def test_get_public_params_and_create_from_public_params(small):
    server = CuckooHashingSparseDpfPirServer.create_plain(
        _port_params(small.params), small.db, device="cpu")
    wire = server.get_public_params()
    assert wire == small.jserver.get_public_params().SerializeToString()
    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        wire, encrypt_decrypt.encrypt)
    assert client._bucket_indices(small.queries) == small.jclient._bucket_indices(small.queries)
    dense = DenseDpfPirServer.create_plain(
        DenseDpfPirDatabase([b"x"] * 10, device="cpu"), device="cpu")
    assert dense.get_public_params() == b""
    with pytest.raises(ValueError, match="do not contain cuckoo hashing parameters"):
        CuckooHashingSparseDpfPirClient.create_from_public_params(
            dense.get_public_params(), encrypt_decrypt.encrypt)
    # Bytes of the JAX package's protobuf parse the same way.
    proto = pir_pb2.PirServerPublicParams()
    proto.ParseFromString(wire)
    assert serialization.parse_public_params(proto.SerializeToString()) == server.public_params


def _port_params(jparams):
    return CuckooHashingParams(
        jparams.num_buckets, jparams.num_hash_functions,
        HashFamilyConfig(jparams.hash_family_config.hash_family,
                         jparams.hash_family_config.seed))


# -- the database -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["small", "ragged", "edges"])
def test_builder_layout_equals_jax(case, request):
    c = request.getfixturevalue(case)
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(_port_params(c.params))
    for kv in c.records.items():
        builder.insert(kv)
    db = builder.build(device="cpu")
    assert db.slots == c.jdb.slots == c.db.slots
    assert (db.size, db.num_buckets, db.num_selection_blocks, db.max_value_size) == (
        c.jdb.size, c.jdb.num_buckets, c.jdb.num_selection_blocks, c.jdb.max_value_size)
    assert (db.key_size, db.value_size) == (c.jdb.key_database.max_value_size,
                                            c.jdb.value_database.max_value_size)
    assert np.array_equal(to_numpy(db.dense_database.db_words),
                          to_numpy(c.db.dense_database.db_words))


def test_builder_errors_equal_jax():
    params = JServer.generate_params(4, seed=SEED)
    for lib_db in (JDatabase, CuckooHashedDpfPirDatabase):
        with pytest.raises(ValueError, match="params must be set before build"):
            lib_db.Builder().build()
    with pytest.raises(ValueError, match="num_elements must be positive"):
        CuckooHashingSparseDpfPirServer.generate_params(0, seed=SEED)
    port = CuckooHashedDpfPirDatabase.Builder().set_params(_port_params(params))
    port.insert((b"", b"v"))
    with pytest.raises(ValueError, match="key cannot be empty"):
        port.build(device="cpu")
    empty = CuckooHashedDpfPirDatabase.Builder().set_params(_port_params(params)).build(
        device="cpu")
    assert empty.size == 0 and all(s is None for s in empty.slots)
    unspecified = CuckooHashingParams(6, 3, HashFamilyConfig(0, SEED))
    with pytest.raises(ValueError, match="hash family unspecified"):
        CuckooHashedDpfPirDatabase.Builder().set_params(unspecified).insert(
            (b"k", b"v")).build(device="cpu")
    other = CuckooHashingSparseDpfPirServer.generate_params(5, seed=SEED)
    with pytest.raises(ValueError, match="does not match params.num_buckets"):
        CuckooHashingSparseDpfPirServer(other, empty, device="cpu")


def test_python_table_path_gives_the_python_layout():
    """A family other than SHA256 runs `CuckooHashTable` (here a SHA256
    table by another id, patched into the config's factory)."""
    from distributed_point_functions_tpu_torch.hashing import CuckooHashTable, SHA256HashFamily
    from distributed_point_functions_tpu_torch.hashing.hash_family import (
        create_hash_functions,
        wrap_with_seed,
    )
    from distributed_point_functions_tpu_torch.pir import cuckoo_database as cdb

    keys = [b"k%d" % i for i in range(50)]
    params = CuckooHashingParams(75, 3, HashFamilyConfig(2, SEED))
    saved = cdb.create_hash_family_from_config
    cdb.create_hash_family_from_config = lambda config: wrap_with_seed(
        SHA256HashFamily(), config.seed)
    try:
        slots = cuckoo_slots(params, keys)
    finally:
        cdb.create_hash_family_from_config = saved
    table = CuckooHashTable(create_hash_functions(
        wrap_with_seed(SHA256HashFamily(), SEED), 3), 75, 128, max_stash_size=0)
    for k in keys:
        table.insert(k)
    assert [None if i < 0 else keys[i] for i in slots] == table.get_table()


def test_records_to_rows_places_ragged_records():
    rng = np.random.default_rng(5)
    recs = [rng.bytes(int(rng.integers(0, 13))) for _ in range(200)] + [b"", b"z" * 12]
    rows = records_to_rows(recs, 256, 12)
    want = np.zeros((256, 12), dtype=np.uint8)
    for i, r in enumerate(recs):
        want[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
    assert np.array_equal(rows, want)
    same = records_to_rows([b"abcd"] * 3, 4, 8)
    assert same.tolist() == [list(b"abcd") + [0] * 4] * 3 + [[0] * 8]


# -- serving ------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["small", "ragged", "edges"])
@pytest.mark.parametrize("expansion", EXPANSION_MODES)
def test_plain_responses_equal_jax(case, expansion, request):
    c = request.getfixturevalue(case)
    server = CuckooHashingSparseDpfPirServer.create_plain(
        _port_params(c.params), c.db, device="cpu", expansion=expansion)
    cuda_lib.reset_launch_counts()
    assert c.serve(server) == c.want
    assert not any(cuda_lib.LAUNCHES.values())


# The streaming tier in every mode (each mode's exit order meets the
# streaming block order), the chunked tier in the default one.
@pytest.mark.parametrize("tier,expansion", [("streaming", m) for m in EXPANSION_MODES]
                         + [("chunked", "walk")])
def test_every_tier_equals_jax(ragged, tier, expansion):
    server = CuckooHashingSparseDpfPirServer.create_plain(
        _port_params(ragged.params), ragged.db, device="cpu", expansion=expansion)
    server_mod.set_tier_floor(tier)
    try:
        assert server.dense_server._plan_serving(3 * QUERIES).mode == tier
        assert ragged.serve(server) == ragged.want
    finally:
        server_mod.clear_tier_floor()


def test_reconstruction_and_key_not_found(ragged, edges):
    for c in (ragged, edges):
        client = CuckooHashingSparseDpfPirClient.create(_port_params(c.params),
                                                        encrypt_decrypt.encrypt)
        raw = [bytes(a ^ b for a, b in zip(x, y)) for x, y in zip(*c.want)]
        got = client._match(raw, c.queries)
        for q, v in zip(c.queries, got):
            if q in c.records:
                want = c.records[q]
                assert v[:len(want)] == want and not any(v[len(want):])
                assert len(v) == c.db.value_size
            else:
                assert v is None


def test_selection_blocks_for_keys_equal_jax(ragged):
    server = CuckooHashingSparseDpfPirServer.create_plain(
        _port_params(ragged.params), ragged.db, device="cpu")
    request = _port_request(server.dpf, ragged.jrequests[1], ragged.jserver.dpf)
    want = j_selection_blocks(ragged.jserver.dpf, ragged.jrequests[1].plain_request.dpf_keys,
                              ragged.jdb.num_selection_blocks)
    for mode in EXPANSION_MODES:
        got = selection_blocks_for_keys(server.dpf, request.plain_request.dpf_keys,
                                        ragged.db.num_selection_blocks, device="cpu",
                                        mode=mode)
        assert np.array_equal(to_numpy(got), np.asarray(want))
    pairs = ragged.db.inner_product_with(got)
    assert [x for kv in pairs for x in kv] == ragged.want[1]


# -- the two-server deployment --------------------------------------------------------


@pytest.fixture(scope="module")
def roles(ragged):
    params = _port_params(ragged.params)
    helper = CuckooHashingSparseDpfPirServer.create_helper(
        params, ragged.db, encrypt_decrypt.decrypt, device="cpu")

    def sender(helper_request, while_waiting):
        while_waiting()
        return helper.handle_request(helper_request)

    leader = CuckooHashingSparseDpfPirServer.create_leader(
        params, ragged.db, sender, device="cpu")
    assert (leader.role, helper.role) == ("leader", "helper")
    return leader, helper


def _check_resolved(resolved, queries, records, value_size):
    for q, v in zip(queries, resolved):
        if q in records:
            assert v == records[q] + bytes(value_size - len(records[q]))
        else:
            # The JAX client's own `KeyNotFound` class, or the port's.
            assert type(v).__name__ == "KeyNotFound" and v.key == q and not v


def test_leader_helper_end_to_end(ragged, roles):
    leader, _ = roles
    client = CuckooHashingSparseDpfPirClient.create_from_public_params(
        leader.get_public_params(), encrypt_decrypt.encrypt)
    request, state = client.create_request(ragged.queries)
    resolved = client.resolve(leader.handle_request(request), state)
    _check_resolved(resolved, ragged.queries, ragged.records, ragged.db.value_size)
    assert client.handle_response(leader.handle_request(request), state) == [
        None if isinstance(v, KeyNotFound) else v for v in resolved]


def test_jax_client_served_by_the_port_over_the_wire(ragged, roles):
    leader, _ = roles
    request, state = ragged.jclient.create_request(ragged.queries)
    response = leader.handle_request(_port_request(leader.dpf, request, ragged.jserver.dpf))
    back = jser.pir_response_from_proto(
        pir_pb2.PirResponse.FromString(serialization.serialize_pir_response(response)))
    _check_resolved(ragged.jclient.resolve(back, state), ragged.queries, ragged.records,
                    ragged.db.value_size)


def test_response_count_is_checked(ragged, roles):
    leader, _ = roles
    client = CuckooHashingSparseDpfPirClient.create(_port_params(ragged.params),
                                                    encrypt_decrypt.encrypt)
    request, state = client.create_request(ragged.queries[:2])
    response = leader.handle_request(request)
    response.dpf_pir_response.masked_response.pop()
    with pytest.raises(ValueError, match="number of responses must be equal"):
        client.handle_response(response, state)


def test_default_device_raises_without_cuda(small):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CuckooHashingSparseDpfPirServer.create_plain(_port_params(small.params), small.db)
    builder = CuckooHashedDpfPirDatabase.Builder().set_params(_port_params(small.params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        builder.insert((b"k", b"v")).build()
