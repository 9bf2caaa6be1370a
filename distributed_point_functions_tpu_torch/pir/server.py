"""PIR servers: the plain role and the dense server.

The port of the JAX package's `pir/server.py` for the plain role on one
device, materialized tier. `DenseDpfPirServer` binds the role to the
dense database: a request's DPF keys are staged with the shared all-zeros
prefix walked on the host (`dense_eval.stage_keys`), the covering
subtree is expanded on the device (`dense_eval_planes.
evaluate_selection_blocks_planes`) in the server's `expansion` mode --
"walk" (K4 head and tail), "tail" (K6 head, K5 tail) or "level" (K2 per
level, K3 at the leaves) -- and the selections go through the XOR inner
product (K1) against the database's bit-major staging.

A batch whose selections the card cannot hold raises
`torch.cuda.OutOfMemoryError`; the streaming and chunked tiers that
bound selection memory come with the planner. The Leader and Helper roles
come with `prng.py` and `crypto/`.
"""

from __future__ import annotations

import math

from ..device import resolve_device
from ..dpf import DistributedPointFunction, DpfParameters
from ..value_types import XorType
from . import messages
from .database import DenseDpfPirDatabase
from .dense_eval import stage_keys
from .dense_eval_planes import (
    DEFAULT_EXPANSION,
    EXPANSION_MODES,
    evaluate_selection_blocks_planes,
)


class DpfPirServer:
    """Role dispatch shared by DPF-based PIR servers (plain role)."""

    def __init__(self):
        self._role = "plain"

    @property
    def role(self) -> str:
        return self._role

    def handle_request(
        self, request: "messages.PirRequest"
    ) -> "messages.PirResponse":
        return self.handle_plain_request(request)

    def handle_plain_request(self, request):
        raise NotImplementedError


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

    @classmethod
    def create_plain(
        cls, database: DenseDpfPirDatabase, device=None,
        expansion: str = DEFAULT_EXPANSION,
    ) -> "DenseDpfPirServer":
        return cls(database, device=device, expansion=expansion)

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
        staged = stage_keys(keys, self._walk_levels, device=self._device)
        selections = evaluate_selection_blocks_planes(
            *staged,
            expand_levels=self._expand_levels,
            num_blocks=self._num_blocks,
            mode=self._expansion,
        )
        return messages.PirResponse(
            dpf_pir_response=messages.DpfPirResponse(
                masked_response=self._database.inner_product_with(selections)
            )
        )
