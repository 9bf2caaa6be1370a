"""Sparse key-value PIR serving: cuckoo-hashed lookups through the dense
serving sessions (the JAX package's `serving/sparse.py`).

A sparse query is a dense request over the cuckoo bucket space
(`pir/sparse_server.py`): each DPF key selects one bucket, and the server
answers two masked responses a key, the bucket's key and its value. In
the port both come from one inner product over the one staging of bucket
rows, split on the host. The batcher's contract is one result a key, so
`_SparseEvaluationMixin` adapts at that seam alone: its evaluation
returns one `(key_bytes, value_bytes)` pair a DPF key (coalescing,
padding, pipelining and generation binding apply unchanged), and its
plain handler flattens the pairs back to the interleaved wire order of
the JAX package, byte for byte. Deadlines, tenants, admission, brownout,
snapshots and the wire's generation echo are the dense sessions'.

Resolution is the client's (`pir/sparse_client.py`): each queried string
hashes to `num_hash_functions` candidate buckets; the value whose key
matches the query (zero-padded prefix) wins, and a query matching none
resolves to the typed `KeyNotFound`.

Writes are snapshot rotations: build generation N+1 with
`CuckooHashedDpfPirDatabase.Builder.build_from(prev)` (upsert; touched
buckets only), and `SnapshotManager.stage()` prestages just those bucket
rows into the resident staging (`bytes_saved > 0`) before the
batch-boundary flip.

Capacity prices sparse traffic as its own workload: admission charges
`price_sparse_pir_keys`, and the cost ledger joins the terminal batches
under "sparse", so dense recalibration never skews sparse admission.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..capacity.model import default_capacity_model
from ..pir import messages
from ..pir.cuckoo_database import CuckooHashedDpfPirDatabase, CuckooHashingParams
from ..pir.dense_eval_planes import DEFAULT_EXPANSION
from ..pir.sparse_client import (
    CuckooHashingSparseDpfPirClient,
    KeyNotFound,
    _is_prefix_padded_with_zeros,
)
from ..pir.sparse_server import CuckooHashingSparseDpfPirServer
from ..prng import xor_bytes
from .metrics import MetricsRegistry
from .service import (
    _DEADLINE,
    _EVAL_GENERATION,
    _TENANT,
    HelperSession,
    LeaderSession,
    PlainSession,
    ServingConfig,
    _admitted_cost,
)
from .transport import Transport

__all__ = [
    "SparseHelperSession",
    "SparseLeaderSession",
    "SparsePlainSession",
    "make_sparse_client",
    "sparse_lookup",
    "sparse_lookup_plain",
]


class _SparseEvaluationMixin:
    """Adapts the dense session mechanics to the sparse server's two
    responses a key (see the module docstring)."""

    def _sparse_init(self) -> None:
        """Price sparse work as its own workload, for admission and for
        the terminal batches' cost-ledger pairs."""
        model = default_capacity_model()
        num_blocks = self._server.database.num_selection_blocks

        def pricer(num_keys):
            return model.price_sparse_pir_keys(num_keys, num_blocks)

        if self._batcher is not None:
            self._batcher.set_cost_model("sparse", pricer)
        if self.admission is not None:
            self.admission.set_pricer(pricer)

    def _evaluate_keys(self, keys):
        """One device step for the coalesced bucket-space key batch: one
        `(key_bytes, value_bytes)` pair a DPF key (a padding key's pair is
        well formed and discarded)."""
        masked = super()._evaluate_keys(keys)
        if len(masked) != 2 * len(keys):
            raise RuntimeError(
                f"sparse evaluation returned {len(masked)} masked responses "
                f"for {len(keys)} keys (want 2 a key)")
        return [(masked[2 * i], masked[2 * i + 1]) for i in range(len(keys))]

    def _batched_plain_handler(self, request):
        keys = request.plain_request.dpf_keys
        out, generation = self._batcher.submit_ex(
            keys, deadline=_DEADLINE.get(), tenant=_TENANT.get(),
            admitted=_admitted_cost(self._batcher, keys),
        )
        if generation is not None:
            _EVAL_GENERATION.set(generation)
        masked = []
        for key_bytes, value_bytes in out:
            masked.append(key_bytes)
            masked.append(value_bytes)
        return messages.PirResponse(
            dpf_pir_response=messages.DpfPirResponse(masked_response=masked))


class SparsePlainSession(_SparseEvaluationMixin, PlainSession):
    """Single-server (trusted) sparse serving: bucket-space plain
    requests, batched. The two-server deployment is
    `SparseLeaderSession` + `SparseHelperSession`."""

    def __init__(self, params: CuckooHashingParams, database: CuckooHashedDpfPirDatabase,
                 config: Optional[ServingConfig] = None,
                 metrics: Optional[MetricsRegistry] = None, device=None,
                 expansion: str = DEFAULT_EXPANSION):
        server = CuckooHashingSparseDpfPirServer.create_plain(
            params, database, device=device, expansion=expansion)
        super().__init__(config=config, metrics=metrics, server=server)
        self._sparse_init()


class SparseHelperSession(_SparseEvaluationMixin, HelperSession):
    """The Helper role over a sparse database: decrypts its leg,
    evaluates the bucket-space batch, masks both response streams."""

    def __init__(self, params: CuckooHashingParams, database: CuckooHashedDpfPirDatabase,
                 decrypter, config: Optional[ServingConfig] = None,
                 metrics: Optional[MetricsRegistry] = None, device=None,
                 expansion: str = DEFAULT_EXPANSION):
        server = CuckooHashingSparseDpfPirServer.create_helper(
            params, database, decrypter, device=device, expansion=expansion)
        super().__init__(config=config, metrics=metrics, server=server)
        self._sparse_init()


class SparseLeaderSession(_SparseEvaluationMixin, LeaderSession):
    """The Leader role over a sparse database: forwards the encrypted
    Helper leg (retries, breaker, the generation handshake: all the dense
    Leader's), computes its own two-a-key share meanwhile, and XORs."""

    def __init__(self, params: CuckooHashingParams, database: CuckooHashedDpfPirDatabase,
                 helper_transport: Transport, config: Optional[ServingConfig] = None,
                 metrics: Optional[MetricsRegistry] = None, device=None,
                 expansion: str = DEFAULT_EXPANSION):
        # The server takes the bound sender before LeaderSession's
        # __init__ runs; it fires only at request time.
        self._transport = helper_transport
        server = CuckooHashingSparseDpfPirServer.create_leader(
            params, database, self._send_to_helper, device=device, expansion=expansion)
        super().__init__(helper_transport=helper_transport, config=config,
                         metrics=metrics, server=server)
        self._sparse_init()


# -- client-side lookups ------------------------------------------------------


def make_sparse_client(session, encrypter=None) -> CuckooHashingSparseDpfPirClient:
    """A lookup client on `session`'s cuckoo geometry. Without an
    `encrypter` the Helper leg is left in plaintext (a `SparsePlainSession`
    or a test); pass the deployment's encrypter for a real Leader."""
    if encrypter is None:
        encrypter = lambda pt, info: pt  # noqa: E731 - plaintext leg
    return CuckooHashingSparseDpfPirClient.create(session.server.public_params, encrypter)


def sparse_lookup(session, client, query: Sequence[bytes]) -> List:
    """One key-value lookup through a combining session
    (`SparseLeaderSession`): per queried string its value bytes, else
    `KeyNotFound(key)`."""
    request, state = client.create_request(list(query))
    return client.resolve(session.handle_request(request), state)


def sparse_lookup_plain(session, client, query: Sequence[bytes]) -> List:
    """A lookup against one `SparsePlainSession` with both plain shares:
    the XOR of the two masked streams is the plaintext (key, value)
    candidates. Per queried string its value bytes, else
    `KeyNotFound(key)`."""
    qbytes = [q.encode() if isinstance(q, str) else bytes(q) for q in query]
    r0, r1 = client.create_plain_requests(qbytes)
    a = session.handle_request(r0).dpf_pir_response.masked_response
    b = session.handle_request(r1).dpf_pir_response.masked_response
    raw = [xor_bytes(x, y) for x, y in zip(a, b)]
    num_hashes = session.server.public_params.num_hash_functions
    results: List = []
    for i, q in enumerate(qbytes):
        found = None
        for j in range(num_hashes):
            k = 2 * (num_hashes * i + j)
            if found is None and _is_prefix_padded_with_zeros(raw[k], q):
                found = raw[k + 1]
        results.append(found if found is not None else KeyNotFound(q))
    return results
