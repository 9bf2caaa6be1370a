"""PIR servers: the Plain, Leader and Helper roles and the dense server.

The port of the JAX package's `pir/server.py` on one device.
`DpfPirServer` carries the deployment roles of the reference:

* **Plain** answers a plain request (one party's keys) directly.
* **Leader** takes the client's `LeaderRequest`, hands the encrypted
  Helper request to an injected `sender`, which must call `while_waiting`
  (the Leader serves its own share there) before it returns the Helper's
  masked response, and XORs the two responses.
* **Helper** decrypts its request with an injected `decrypter`, parses it
  (`messages.parse_helper_request`), serves the plain share and masks each
  response with the AES-CTR one-time pad of the client's seed (`prng.py`).

Transport and encryption are callbacks, so any RPC stack and hybrid
scheme plug in (`crypto/hybrid.py`, `testing/encrypt_decrypt.py`).
Every role serves its plain share through `_dispatch_plain`: by default
`handle_plain_request`, the same device path; `set_plain_handler`
routes it elsewhere (the serving runtime's batcher, `serving/`).
`swap_database` replaces the served database with a new generation of
the same geometry, and `prestage_database` stages one beforehand
(`serving/snapshots.py`).

`DenseDpfPirServer` binds the roles to the dense database: a request's
DPF keys are staged with the shared all-zeros prefix walked on the host
(`dense_eval.stage_keys`, on the native host library, which the
constructor builds so that no request pays for it), and the planner
(`planner.py`) picks the tier that serves the batch within the
selection-memory budget of the capacity model (`capacity/model.py`):

* materialized -- the covering subtree is expanded on the device
  (`dense_eval_planes.evaluate_selection_blocks_planes`) and the whole
  selection matrix goes through the database's inner product (K1, or K7
  for a v1 database);
* streaming -- the expansion down to a cut, then per chunk the tail
  expansion and K1's accumulate entry against the database's streaming
  staging (`dense_eval_planes_v2.streaming_pir_inner_products`);
* chunked -- per chunk a K8 walk to its root, the expansion and K1's
  accumulate entry against a span of the natural staging
  (`dense_eval.chunked_pir_inner_products`).

Every tier expands in the server's `expansion` mode -- "walk" (K4 head and
tail), "tail" (K6 head, K5 tail) or "level" (K2 per level, K3 at the
leaves) -- and every tier returns the same bytes. `set_tier_floor` forces
every server of the process to a tier or a cheaper one. A batch that
still outgrows the card raises `torch.cuda.OutOfMemoryError`: there is no
demotion after an out-of-memory error, no fallback.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

from .. import native
from ..device import resolve_device
from ..dpf import DistributedPointFunction, DpfParameters
from ..observability import phases as phases_mod
from ..observability.device import default_telemetry
from ..prng import Aes128CtrSeededPrng, mask_all, xor_bytes
from ..value_types import XorType
from . import messages
from .client import ENCRYPTION_CONTEXT_INFO
from .database import DenseDpfPirDatabase, read_back, words_to_record_bytes
from .dense_eval import chunked_pir_inner_products, stage_keys
from .dense_eval_planes import (
    DEFAULT_EXPANSION,
    EXPANSION_MODES,
    evaluate_selection_blocks_planes,
)
from .dense_eval_planes_v2 import streaming_pir_inner_products
from .planner import CHUNK_GRANULE_LEVELS, TIERS, ServingPlan, plan_dense_serving

# sender(helper_request: PirRequest, while_waiting: Callable[[], None])
#   -> PirResponse
ForwardHelperRequestFn = Callable[..., "messages.PirResponse"]
# decrypter(ciphertext: bytes, context_info: bytes) -> bytes
DecryptHelperRequestFn = Callable[[bytes, bytes], bytes]

# The process-wide tier floor: index into TIERS of the most expensive tier
# any dense-PIR plan may take (0: unconstrained).
_TIER_FLOOR = 0


def set_tier_floor(mode: Optional[str]) -> None:
    """Force every dense-PIR plan in this process to `mode` or a cheaper
    tier ("materialized", "streaming" or "chunked"); None or
    "materialized" clears the constraint."""
    global _TIER_FLOOR
    _TIER_FLOOR = 0 if mode is None else TIERS.index(mode)


def clear_tier_floor() -> None:
    set_tier_floor(None)


def tier_floor() -> str:
    return TIERS[_TIER_FLOOR]


class DpfPirServer:
    """Role dispatch shared by DPF-based PIR servers."""

    def __init__(self):
        self._role = "plain"
        self._sender: Optional[ForwardHelperRequestFn] = None
        self._decrypter: Optional[DecryptHelperRequestFn] = None
        self._encryption_context_info = ENCRYPTION_CONTEXT_INFO
        self._plain_handler: Optional[Callable] = None

    def make_leader(self, sender: ForwardHelperRequestFn) -> None:
        if sender is None:
            raise ValueError("sender may not be None")
        self._sender = sender
        self._role = "leader"

    def make_helper(
        self,
        decrypter: DecryptHelperRequestFn,
        encryption_context_info: bytes = ENCRYPTION_CONTEXT_INFO,
    ) -> None:
        if decrypter is None:
            raise ValueError("decrypter may not be None")
        self._decrypter = decrypter
        self._encryption_context_info = encryption_context_info
        self._role = "helper"

    @property
    def role(self) -> str:
        return self._role

    def set_plain_handler(self, handler: Optional[Callable]) -> None:
        """Route every role's plain evaluation (the plain role's
        requests, the Leader's own share inside `while_waiting`, the
        Helper's decrypted request) through `handler(request) ->
        PirResponse`; None restores `handle_plain_request`. The handler
        may itself call `handle_plain_request`, the evaluation."""
        self._plain_handler = handler

    def _dispatch_plain(self, request):
        handler = self._plain_handler
        if handler is not None:
            return handler(request)
        return self.handle_plain_request(request)

    def handle_request(
        self, request: "messages.PirRequest"
    ) -> "messages.PirResponse":
        if self._role == "plain":
            return self._dispatch_plain(request)
        if self._role == "leader":
            return self._handle_leader_request(request)
        return self._handle_helper_request(request)

    def get_public_params(self) -> bytes:
        """The `PirServerPublicParams` bytes a client reads before any
        query (`serialization.serialize_public_params`): the dense server
        has none, so the base gives the empty message; the sparse server
        gives its cuckoo parameters."""
        from .. import serialization

        return serialization.serialize_public_params(None)

    def handle_plain_request(self, request):
        raise NotImplementedError

    def _parse_helper_request(self, data: bytes) -> "messages.HelperRequest":
        """Decode the decrypted Helper request (the subclass knows the DPF)."""
        raise NotImplementedError

    def _handle_leader_request(self, request):
        if request.leader_request is None:
            raise ValueError("request must be a valid LeaderRequest")
        leader_request = request.leader_request
        if leader_request.plain_request is None:
            raise ValueError("plain_request must be set")
        if leader_request.encrypted_helper_request is None:
            raise ValueError("encrypted_helper_request must be set")
        plain_request = messages.PirRequest(plain_request=leader_request.plain_request)
        helper_request = messages.PirRequest(
            encrypted_helper_request=leader_request.encrypted_helper_request)

        # The sender must call while_waiting, which serves the Leader's own
        # share while the Helper works; a sender that does not is caught
        # after it returns. An error in the Leader's share propagates out
        # through the sender.
        state = {}

        def while_waiting():
            state["response"] = self._dispatch_plain(plain_request)

        helper_response = self._sender(helper_request, while_waiting)
        if "response" not in state:
            raise RuntimeError(
                "handle_request: while_waiting was not called from the "
                "sender passed at construction"
            )
        hr = helper_response.dpf_pir_response.masked_response
        lr = state["response"].dpf_pir_response.masked_response
        if len(hr) != len(lr):
            raise RuntimeError(
                f"number of responses from Helper (={len(hr)}) does not "
                f"match the number of responses from Leader (={len(lr)})"
            )
        for i, (h, l) in enumerate(zip(hr, lr)):
            if len(h) != len(l):
                raise RuntimeError(
                    f"response size mismatch at index {i}: got {len(h)} "
                    f"(Helper) vs. {len(l)} (Leader)"
                )
        return messages.PirResponse(dpf_pir_response=messages.DpfPirResponse(
            masked_response=[xor_bytes(h, l) for h, l in zip(hr, lr)]))

    def _handle_helper_request(self, request):
        if request.encrypted_helper_request is None:
            raise ValueError("request must be a valid EncryptedHelperRequest")
        inner = self._parse_helper_request(self._decrypter(
            request.encrypted_helper_request.encrypted_request,
            self._encryption_context_info,
        ))
        response = self._dispatch_plain(
            messages.PirRequest(plain_request=inner.plain_request))
        return messages.PirResponse(dpf_pir_response=messages.DpfPirResponse(
            masked_response=mask_all(response.dpf_pir_response.masked_response,
                                     Aes128CtrSeededPrng(inner.one_time_pad_seed))))


class DenseDpfPirServer(DpfPirServer):
    """PIR over a dense index space, on one device."""

    def __init__(self, database: DenseDpfPirDatabase, device=None,
                 expansion: str = DEFAULT_EXPANSION):
        super().__init__()
        if database is None:
            raise ValueError("database cannot be None")
        if expansion not in EXPANSION_MODES:
            raise ValueError(
                f"expansion must be one of {EXPANSION_MODES}, got {expansion!r}"
            )
        self._expansion = expansion
        self._device = resolve_device(device)
        if database.device != self._device:
            raise ValueError(
                f"database lives on {database.device}, server runs on "
                f"{self._device}"
            )
        if database.size <= 0:
            raise ValueError("database must not be empty")
        self._database = database
        self._log_domain_size = max(0, math.ceil(math.log2(database.size)))
        self._dpf = DistributedPointFunction.create(
            DpfParameters(
                log_domain_size=self._log_domain_size,
                value_type=XorType(128),
            )
        )
        # Only the first ceil(size/128) leaf blocks carry selection bits:
        # walk the shared prefix on the host, expand the covering subtree.
        self._num_blocks = database.num_selection_blocks
        k = max(0, (self._num_blocks - 1).bit_length())
        total_levels = self._dpf._tree_levels_needed - 1
        self._expand_levels = min(k, total_levels)
        self._walk_levels = total_levels - self._expand_levels
        # Build (or load) the host library that stages and walks the keys
        # now, so that no request pays for the build.
        native.get_lib()

    @classmethod
    def create_plain(
        cls, database: DenseDpfPirDatabase, device=None,
        expansion: str = DEFAULT_EXPANSION,
    ) -> "DenseDpfPirServer":
        return cls(database, device=device, expansion=expansion)

    @classmethod
    def create_leader(
        cls, database: DenseDpfPirDatabase, sender: ForwardHelperRequestFn,
        device=None, expansion: str = DEFAULT_EXPANSION,
    ) -> "DenseDpfPirServer":
        server = cls(database, device=device, expansion=expansion)
        server.make_leader(sender)
        return server

    @classmethod
    def create_helper(
        cls, database: DenseDpfPirDatabase, decrypter: DecryptHelperRequestFn,
        device=None, expansion: str = DEFAULT_EXPANSION,
    ) -> "DenseDpfPirServer":
        server = cls(database, device=device, expansion=expansion)
        server.make_helper(decrypter, ENCRYPTION_CONTEXT_INFO)
        return server

    @property
    def device(self):
        return self._device

    @property
    def dpf(self) -> DistributedPointFunction:
        return self._dpf

    @property
    def database(self) -> DenseDpfPirDatabase:
        return self._database

    @property
    def expansion(self) -> str:
        return self._expansion

    @property
    def expand_levels(self) -> int:
        return self._expand_levels

    @property
    def walk_levels(self) -> int:
        return self._walk_levels

    def _parse_helper_request(self, data: bytes) -> "messages.HelperRequest":
        return messages.parse_helper_request(self._dpf, data)

    def swap_database(self, database: DenseDpfPirDatabase) -> DenseDpfPirDatabase:
        """Serve `database`, a new generation of the same geometry, from
        the next batch on; returns the old one (still staged: the caller
        frees it with `release_stagings` once its batches have drained;
        `database`, once staged, no longer holds it).
        Safe only at a batch boundary (`serving/snapshots.py`): each
        batch reads the database once, the swap is one assignment."""
        if database is None:
            raise ValueError("database cannot be None")
        old = self._database
        for what, new_v, old_v in (
            ("size", database.size, old.size),
            ("num_selection_blocks", database.num_selection_blocks,
             old.num_selection_blocks),
            ("max_value_size", database.max_value_size, old.max_value_size),
            ("device", database.device, old.device),
        ):
            if new_v != old_v:
                raise ValueError(
                    f"swap_database {what} mismatch: {new_v} != {old_v}")
        database.mark_serving()
        self._database = database
        return old

    def prestage_database(self, database: DenseDpfPirDatabase) -> int:
        """Stage `database` the way this server serves it, before a flip
        (`DenseDpfPirDatabase.prestage`); returns the bytes moved."""
        return database.prestage()

    def handle_plain_request(
        self, request: "messages.PirRequest"
    ) -> "messages.PirResponse":
        if request.plain_request is None:
            raise ValueError("request must contain a valid PlainRequest")
        keys = request.plain_request.dpf_keys
        if not keys:
            raise ValueError("dpf_keys must not be empty")
        expected_cw = self._dpf._tree_levels_needed - 1
        for key in keys:
            if key.party not in (0, 1):
                raise ValueError("key.party must be 0 or 1")
            if len(key.correction_words) != expected_cw:
                raise ValueError(
                    f"key has {len(key.correction_words)} correction words, "
                    f"expected {expected_cw}"
                )
        plan = self._plan_serving(len(keys))
        # The batch-scoped phase record (batched serving) keys the cost
        # ledger's residual cell by the tier that ran.
        record = phases_mod.current_request()
        if record is not None:
            record.set_meta("serving_plan", {"mode": plan.mode, "num_keys": plan.num_keys})
        return messages.PirResponse(
            dpf_pir_response=messages.DpfPirResponse(
                masked_response=self._execute_plan(plan, keys, self._database)
            )
        )

    def _plan_serving(self, num_keys: int) -> ServingPlan:
        """The planner's tier for a batch of `num_keys` keys, at or below
        the process-wide tier floor."""
        plan = plan_dense_serving(
            num_keys=num_keys,
            num_blocks=self._num_blocks,
            expand_levels=self._expand_levels,
        )
        floor = _TIER_FLOOR
        if floor and TIERS.index(plan.mode) < floor:
            plan = plan_dense_serving(
                num_keys=num_keys,
                num_blocks=self._num_blocks,
                expand_levels=self._expand_levels,
                force_mode=TIERS[floor],
            )
        return plan

    def _stage_keys(self, keys):
        """The keys staged on the device (`dense_eval.stage_keys`), their
        one host-to-device copy counted in the transfer ledger."""
        staged = stage_keys(keys, self._walk_levels, device=self._device)
        if self._device.type == "cuda":
            default_telemetry().transfers.record_h2d(
                sum(t.numel() * 4 for t in staged), "key_staging")
        return staged

    def _execute_plan(self, plan: ServingPlan, keys,
                      database: DenseDpfPirDatabase) -> List[bytes]:
        """Serve `keys` on `plan` against `database` (read once by the
        caller, so a swap between two batches never splits one)."""
        if plan.mode == "streaming":
            return self._inner_products_streaming(plan, keys, database)
        if plan.mode == "chunked":
            return self._inner_products_chunked(plan, keys, database)
        staged = self._stage_keys(keys)
        selections = evaluate_selection_blocks_planes(
            *staged,
            expand_levels=self._expand_levels,
            num_blocks=self._num_blocks,
            mode=self._expansion,
        )
        return database.inner_product_with(selections)

    def _inner_products_streaming(self, plan: ServingPlan, keys,
                                  database: DenseDpfPirDatabase) -> List[bytes]:
        """The streaming tier: tail expansion and K1's accumulate entry per
        chunk, no materialized selection matrix."""
        staged = self._stage_keys(keys)
        out = streaming_pir_inner_products(
            *staged,
            database.streaming_chunks(plan.cut_levels),
            cut_levels=plan.cut_levels,
            chunk_levels=plan.chunk_levels,
            mode=self._expansion,
        )
        return words_to_record_bytes(
            read_back(out), len(keys), database.max_value_size)

    def _chunked_database(self, database: DenseDpfPirDatabase):
        """(padded block count, staging) of the chunked tier: the block
        count padded to a multiple of 2^min(expand_levels, 10) blocks, so
        that the staging does not depend on the batch size
        (`DenseDpfPirDatabase.chunked_staging` builds it once)."""
        granule = 1 << min(self._expand_levels, CHUNK_GRANULE_LEVELS)
        padded_blocks = -(-self._num_blocks // granule) * granule
        return padded_blocks, database.chunked_staging(granule)

    def _inner_products_chunked(self, plan: ServingPlan, keys,
                                database: DenseDpfPirDatabase) -> List[bytes]:
        """The chunked tier: one chunk's selections live at a time. The
        chunk count follows from the granule-padded block count (the
        plan's num_chunks is its lower bound)."""
        padded_blocks, db = self._chunked_database(database)
        cel = plan.chunk_levels
        staged = self._stage_keys(keys)
        out = chunked_pir_inner_products(
            *staged,
            db,
            chunk_bits=self._expand_levels - cel,
            chunk_expand_levels=cel,
            num_chunks=padded_blocks >> cel,
            mode=self._expansion,
        )
        return words_to_record_bytes(
            read_back(out), len(keys), database.max_value_size)
