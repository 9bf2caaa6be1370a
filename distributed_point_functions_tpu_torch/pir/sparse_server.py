"""Sparse (string-keyed) PIR server over a cuckoo-hashed database: the port
of the JAX package's `pir/sparse_server.py`
(`pir/cuckoo_hashing_sparse_dpf_pir_server.{h,cc}`).

`generate_params` draws 3 hash functions over `1.5 * num_elements` buckets
with a random 16-byte seed (`cuckoo_hashing_sparse_dpf_pir_server.cc:36-65`).
Requests are dense-PIR requests over the bucket space; each query returns
two masked responses, the bucket's key and then its value
(`cuckoo_hashing_sparse_dpf_pir_server.cc:126-165`).

The server composes a `DenseDpfPirServer` over the database's one dense
staging of bucket rows (`CuckooHashedDpfPirDatabase.dense_database`): a
batch is planned and served by the dense server's planner and tiers
(materialized, streaming or chunked, in the server's expansion mode), so
one expansion and one inner product serve keys and values, and each
response row is split on the host. The roles (Plain, Leader, Helper) are
`DpfPirServer`'s. A snapshot rotation (`serving/snapshots.py`) checks a
new generation with `validate_snapshot` (the same cuckoo geometry and
row layout), stages it with `prestage_database` and swaps it in with
`swap_database`, which swaps the dense server's staging too. Serving
across several cards comes with the port's multi-device slice.
"""

from __future__ import annotations

import secrets

from ..dpf import DistributedPointFunction
from ..hashing.hash_family_config import (
    HASH_FAMILY_SHA256,
    HASH_FUNCTION_SEED_LENGTH_BYTES,
    HashFamilyConfig,
)
from . import messages
from .client import ENCRYPTION_CONTEXT_INFO
from .cuckoo_database import CuckooHashedDpfPirDatabase, CuckooHashingParams
from .dense_eval_planes import DEFAULT_EXPANSION
from .server import (
    DecryptHelperRequestFn,
    DenseDpfPirServer,
    DpfPirServer,
    ForwardHelperRequestFn,
)

NUM_HASH_FUNCTIONS = 3
BUCKETS_PER_ELEMENT = 1.5


class CuckooHashingSparseDpfPirServer(DpfPirServer):
    """See module docstring. `device` and `expansion` as `DenseDpfPirServer`'s
    (None: the CUDA card; the database must live there)."""

    def __init__(self, params: CuckooHashingParams,
                 database: CuckooHashedDpfPirDatabase, device=None,
                 expansion: str = DEFAULT_EXPANSION):
        super().__init__()
        if params.num_buckets <= 0:
            raise ValueError("num_buckets must be positive")
        if params.num_hash_functions <= 0:
            raise ValueError("num_hash_functions must be positive")
        if database is None:
            raise ValueError("database cannot be None")
        if database.num_buckets != params.num_buckets:
            raise ValueError(
                "number of buckets in the database does not match "
                "params.num_buckets"
            )
        self._params = params
        self._database = database
        # The DPF's domain is the bucket space, as the JAX package's sparse
        # server has it: ceil(log2(num_buckets)).
        self._dense = DenseDpfPirServer(database.dense_database, device=device,
                                        expansion=expansion)

    @staticmethod
    def generate_params(
        num_elements: int,
        hash_family: int = HASH_FAMILY_SHA256,
        seed: bytes | None = None,
    ) -> CuckooHashingParams:
        if num_elements <= 0:
            raise ValueError("num_elements must be positive")
        if seed is None:
            seed = secrets.token_bytes(HASH_FUNCTION_SEED_LENGTH_BYTES)
        return CuckooHashingParams(
            num_buckets=int(BUCKETS_PER_ELEMENT * num_elements),
            num_hash_functions=NUM_HASH_FUNCTIONS,
            hash_family_config=HashFamilyConfig(
                hash_family=hash_family, seed=seed
            ),
        )

    # -- constructors -------------------------------------------------------

    @classmethod
    def create_plain(cls, params, database, device=None,
                     expansion: str = DEFAULT_EXPANSION):
        return cls(params, database, device=device, expansion=expansion)

    @classmethod
    def create_leader(cls, params, database, sender: ForwardHelperRequestFn,
                      device=None, expansion: str = DEFAULT_EXPANSION):
        server = cls(params, database, device=device, expansion=expansion)
        server.make_leader(sender)
        return server

    @classmethod
    def create_helper(cls, params, database, decrypter: DecryptHelperRequestFn,
                      device=None, expansion: str = DEFAULT_EXPANSION):
        server = cls(params, database, device=device, expansion=expansion)
        server.make_helper(decrypter, ENCRYPTION_CONTEXT_INFO)
        return server

    # -- request handling ---------------------------------------------------

    @property
    def public_params(self) -> CuckooHashingParams:
        """The params a client needs (hash config + bucket count)."""
        return self._params

    @property
    def database(self) -> CuckooHashedDpfPirDatabase:
        return self._database

    @property
    def device(self):
        return self._dense.device

    def validate_snapshot(self, database: CuckooHashedDpfPirDatabase) -> None:
        """Raise ValueError unless `database` may replace the serving one:
        the same cuckoo geometry (bucket count and params: a client
        hashing with the serving params must land on the new layout's
        buckets) and the same rows (selection blocks, key and value
        bytes: a response keeps its shape across the flip)."""
        if database is None:
            raise ValueError("database cannot be None")
        if not isinstance(database, CuckooHashedDpfPirDatabase):
            raise ValueError("sparse server cannot serve a dense database snapshot")
        if database.num_buckets != self._params.num_buckets:
            raise ValueError(
                f"snapshot has {database.num_buckets} buckets, serving "
                f"geometry has {self._params.num_buckets}")
        if database.params != self._params:
            raise ValueError(
                "snapshot cuckoo params (hash count/family/seed) do not "
                "match the serving geometry")
        cur = self._database
        for what, new_v, old_v in (
            ("selection blocks", database.num_selection_blocks, cur.num_selection_blocks),
            ("key bytes", database.key_size, cur.key_size),
            ("value bytes", database.value_size, cur.value_size),
        ):
            if new_v != old_v:
                raise ValueError(
                    f"snapshot spans {new_v} {what}, serving database {old_v}")

    def prestage_database(self, database: CuckooHashedDpfPirDatabase) -> int:
        """Stage `database`'s bucket rows before a flip; returns the bytes
        moved."""
        return database.prestage()

    def swap_database(self, database: CuckooHashedDpfPirDatabase) -> CuckooHashedDpfPirDatabase:
        """Serve `database` from the next batch on (the snapshot flip, at a
        batch boundary), after `validate_snapshot`; returns the old one."""
        self.validate_snapshot(database)
        self._dense.swap_database(database.dense_database)
        old, self._database = self._database, database
        return old

    @property
    def dense_server(self) -> DenseDpfPirServer:
        """The dense server over the bucket rows: its plan
        (`_plan_serving`), expansion mode and walk split."""
        return self._dense

    @property
    def dpf(self) -> DistributedPointFunction:
        return self._dense.dpf

    def get_public_params(self) -> bytes:
        """The `PirServerPublicParams` bytes of this server's cuckoo
        parameters (`cuckoo_hashing_sparse_dpf_pir_server.h:99`)."""
        from .. import serialization

        return serialization.serialize_public_params(self._params)

    def _parse_helper_request(self, data: bytes) -> "messages.HelperRequest":
        return messages.parse_helper_request(self.dpf, data)

    def handle_plain_request(
        self, request: "messages.PirRequest"
    ) -> "messages.PirResponse":
        """Per key, the XOR of the selected buckets' keys and then of their
        values. The dense server checks the request, plans the batch and
        serves the bucket rows."""
        rows = self._dense.handle_plain_request(request).dpf_pir_response.masked_response
        masked = []
        for row in rows:
            masked.extend(self._database.split_row(row))
        return messages.PirResponse(
            dpf_pir_response=messages.DpfPirResponse(masked_response=masked)
        )
