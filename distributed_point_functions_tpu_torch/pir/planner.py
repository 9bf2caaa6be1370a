"""How a dense-PIR batch is served: the port of the JAX package's
`pir/planner.py`.

Three tiers, in order of the selection memory they keep live:

* `materialized` -- the expansion writes the whole packed selection matrix
  int32[num_keys, num_blocks, 4] and the inner product reads it (K1, or
  K7 for a v1 database). Chosen whenever that matrix fits the budget.
* `streaming` -- the covering subtree is expanded down to `cut_levels`
  once; then each of the `2**cut_levels` tail subtrees is expanded the
  last `chunk_levels` levels and its selections are XORed at once into
  the result against the matching database span (K1's accumulate entry),
  so the whole matrix never exists
  (`dense_eval_planes_v2.streaming_pir_inner_products`). Needs a tree that
  covers the block count, because the database is staged in streaming
  block order.
* `chunked` -- one chunk root at a time is walked down its path bits and
  its subtree expanded and XORed in against the natural-order staging
  (`dense_eval.chunked_pir_inner_products`): the tier for trees that do not
  cover the block count, and the floor.

The byte model is `capacity.model.CapacityModel`, which counts what the
port's tiers hold; this module encodes the JAX package's decision on it
(materialized if it fits, streaming when over budget or forced, chunked
as the floor). The JAX package's `DPF_TPU_STREAMING` and
`DPF_TPU_STREAMING_IP` switches are not carried: streaming applies
whenever the geometry allows it, and its inner product is always K1 (its
plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..capacity.model import default_capacity_model

TIERS = ("materialized", "streaming", "chunked")
# The chunked tier pads the block count so that chunks stay at least this
# many doubling levels deep, whatever the batch size.
CHUNK_GRANULE_LEVELS = 10


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """The serving decision for one dense-PIR batch."""

    mode: str  # one of TIERS
    num_keys: int
    num_blocks: int
    expand_levels: int
    budget_bytes: int
    # The model's peak of live selection bytes in `mode`.
    selection_bytes_peak: int
    # Streaming: expand_levels == cut_levels + chunk_levels and
    # num_chunks == 2**cut_levels. Chunked: chunk_levels is the levels
    # each chunk expands, cut_levels the path bits walked to its root, and
    # num_chunks a lower bound (the server pads the block count to the
    # chunk granule).
    cut_levels: int = 0
    chunk_levels: int = 0
    num_chunks: int = 1


def plan_dense_serving(
    *,
    num_keys: int,
    num_blocks: int,
    expand_levels: int,
    force_mode: Optional[str] = None,
) -> ServingPlan:
    """The tier and its split for one batch of `num_keys` keys over
    `num_blocks` selection blocks, the covering subtree `expand_levels`
    deep, under the process-wide capacity model
    (`capacity.model.default_capacity_model`).

    `force_mode` pins the tier whatever the budget: "streaming" where the
    geometry allows it (else chunked), "chunked" always."""
    if force_mode not in (None,) + TIERS:
        raise ValueError(f"force_mode must be one of {TIERS} or None, got {force_mode!r}")
    cm = default_capacity_model()
    budget = cm.selection_budget_bytes()
    streaming_ok = expand_levels > 0 and (1 << expand_levels) >= num_blocks
    # The expansion holds every leaf of the covering subtree beside the
    # selection matrix: more than num_blocks where the tree is ragged.
    mat_bytes = cm.materialized_selection_bytes(
        num_keys, num_blocks, max(num_blocks, 1 << expand_levels))
    over_budget = mat_bytes > budget and expand_levels > 0
    if force_mode == "streaming" and not streaming_ok:
        force_mode = "chunked"
    if force_mode == "chunked" and expand_levels > 0:
        over_budget = True
        streaming_ok = False

    common = dict(num_keys=num_keys, num_blocks=num_blocks,
                  expand_levels=expand_levels, budget_bytes=budget)
    if streaming_ok and (over_budget or force_mode == "streaming"):
        chunk_levels = cm.pick_streaming_split(num_keys, expand_levels)
        cut_levels = expand_levels - chunk_levels
        return ServingPlan(
            mode="streaming",
            selection_bytes_peak=cm.streaming_selection_bytes(
                num_keys, cut_levels, chunk_levels),
            cut_levels=cut_levels,
            chunk_levels=chunk_levels,
            num_chunks=1 << cut_levels,
            **common,
        )
    if over_budget:
        cel = cm.pick_chunked_expand_levels(num_keys, expand_levels, CHUNK_GRANULE_LEVELS)
        return ServingPlan(
            mode="chunked",
            selection_bytes_peak=cm.chunked_selection_bytes(num_keys, cel),
            cut_levels=expand_levels - cel,
            chunk_levels=cel,
            num_chunks=1 << (expand_levels - cel),
            **common,
        )
    return ServingPlan(mode="materialized", selection_bytes_peak=mat_bytes, **common)
