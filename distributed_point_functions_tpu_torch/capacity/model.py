"""The dense-PIR selection-byte model: the JAX package's
`capacity/model.py` (`CapacityModel`, `:322-591`), counted for this port.

What each serving tier of dense PIR keeps live of the selections at its
peak, in bytes, and how large a streaming or chunked split may be under a
budget. Keys are counted padded to a multiple of 32 (`nkp`): the
expansion runs 32 keys to a word. Each 128-bit block costs 16 bytes in
both forms the port holds it in, the expansion's leaf values (bit
planes) and the selection blocks that `ops.expand_planes.leaf_blocks`
writes from them, and both are alive while that kernel runs:

* materialized: the leaf values of the covering subtree and the selection
  matrix, `nkp * (leaf_blocks + eff_blocks) * 16` (`leaf_blocks` is
  `2**expand_levels`, more than `eff_blocks` where the block count is not a
  power of two: the expansion writes every leaf of the tree before
  `leaf_blocks` keeps the first `eff_blocks`);
* streaming: the cut state for the whole scan plus one chunk's leaf values
  and selections, `nkp * 16 * (2**cut_levels + 2 * 2**chunk_levels)` (the
  JAX model's double buffer);
* chunked: one chunk's leaf values and selections,
  `2 * nkp * 2**chunk_expand_levels * 16`.

This holds in every expansion mode: the fused kernels hold no scratch
beside their outputs. The staged keys and the response rows are not
selections and are not counted.

The budget is an explicit `selection_budget`, else 1/16 of the device's
memory (`device.device_memory_bytes`: the CUDA card's), else 1 GiB (the
CPU). Environment overrides are not read. The JAX model's throughput
calibration, pricing, mesh shapes and heavy-hitters budgets come with the
serving runtime.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..device import device_memory_bytes as probe_device_memory

_SELECTION_BLOCK_BYTES = 16
_DEFAULT_SELECTION_BUDGET = 1 << 30  # 1 GiB
# Selection tensors get 1/16 of known device memory: the database, cut
# states and scratch share the rest (the JAX package's fraction).
_SELECTION_MEMORY_FRACTION = 16


def padded_keys(num_keys: int) -> int:
    """The key count the expansion runs: a multiple of 32."""
    return -(-num_keys // 32) * 32


class CapacityModel:
    """Selection bytes of each dense-PIR tier against a budget."""

    def __init__(self, selection_budget: Optional[int] = None):
        self._device_memory = probe_device_memory()
        self._selection_budget = selection_budget

    def selection_budget_bytes(self) -> int:
        """The budget for selection tensors: the explicit one, else a
        fraction of known device memory, else 1 GiB."""
        if self._selection_budget is not None:
            return max(1, int(self._selection_budget))
        if self._device_memory is not None:
            return max(1, self._device_memory // _SELECTION_MEMORY_FRACTION)
        return _DEFAULT_SELECTION_BUDGET

    def materialized_selection_bytes(self, num_keys: int, eff_blocks: int,
                                     leaf_blocks: Optional[int] = None) -> int:
        """The leaf values (`leaf_blocks` blocks a key, default `eff_blocks`)
        and the selection matrix (`eff_blocks`), one 128-bit block each."""
        leaves = eff_blocks if leaf_blocks is None else leaf_blocks
        return padded_keys(num_keys) * (leaves + eff_blocks) * _SELECTION_BLOCK_BYTES

    def streaming_selection_bytes(
        self, num_keys: int, cut_levels: int, chunk_levels: int
    ) -> int:
        """The cut state for the whole scan plus one chunk's leaf values
        and selections."""
        return padded_keys(num_keys) * _SELECTION_BLOCK_BYTES * (
            (1 << cut_levels) + 2 * (1 << chunk_levels)
        )

    def chunked_selection_bytes(self, num_keys: int, chunk_expand_levels: int) -> int:
        """One chunk's leaf values and selections."""
        return 2 * padded_keys(num_keys) * (1 << chunk_expand_levels) * _SELECTION_BLOCK_BYTES

    def pick_streaming_split(self, num_keys: int, expand_levels: int) -> int:
        """The largest chunk_levels whose streaming bytes fit the budget;
        if none fits, the split with the fewest bytes."""
        budget = self.selection_budget_bytes()
        cost = [
            self.streaming_selection_bytes(num_keys, expand_levels - r, r)
            for r in range(expand_levels + 1)
        ]
        feasible = [r for r, c in enumerate(cost) if c <= budget]
        if feasible:
            return max(feasible)
        return min(range(expand_levels + 1), key=cost.__getitem__)

    def pick_chunked_expand_levels(
        self, num_keys: int, expand_levels: int, granule_levels: int
    ) -> int:
        """The largest chunk_expand_levels, at most `granule_levels`,
        whose one-chunk selections fit the budget; at least 0."""
        budget = self.selection_budget_bytes()
        cel = min(expand_levels, granule_levels)
        while cel > 0 and self.chunked_selection_bytes(num_keys, cel) > budget:
            cel -= 1
        return cel


_default_model: Optional[CapacityModel] = None
_default_lock = threading.Lock()


def default_capacity_model() -> CapacityModel:
    """The process-wide model the planner uses."""
    global _default_model
    with _default_lock:
        if _default_model is None:
            _default_model = CapacityModel()
        return _default_model


def set_default_capacity_model(
    model: Optional[CapacityModel],
) -> Optional[CapacityModel]:
    """Swap the process-wide model (None restores the lazy default);
    returns the previous one."""
    global _default_model
    with _default_lock:
        previous = _default_model
        _default_model = model
        return previous
