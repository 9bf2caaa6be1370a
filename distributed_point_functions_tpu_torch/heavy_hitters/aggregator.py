"""Batched per-level evaluation over the incremental DPF, budgeted.

One server's compute engine for the level-synchronized sweep: evaluate
ALL live keys at ALL candidate prefixes of hierarchy level l as
`[num_keys, num_prefixes]` lanes (`dpf.evaluate_prefixes_batch`: one K8
walk and one K3 value hash a chunk), resuming from the `BatchCutState`
of level l - 1 so each level walks only the newly revealed tree levels,
never from the root again.

The port of the JAX package's `heavy_hitters/aggregator.py`. As for
dense PIR, an explicit byte model decides how the `keys x frontier`
product is served, and its arithmetic lives in `capacity/model.py`
(`CapacityModel.hh_lane_bytes` / `plan_hh_level`): the largest
power-of-two prefix chunk whose lanes fit the frontier budget (an
explicit one, else 1/64 of the card's memory). The aggregator runs the
frontier chunk by chunk; chunked evaluation equals unchunked, lanes
being independent. A chunked level's cut states go into one buffer of
the whole level, allocated before its first chunk (no concatenation
that would hold the level twice); the previous level's are dropped when
the level ends.

The key-axis sum runs on the device (int64 sums of the uint32 words,
taken mod 2^32: the group law) and only the `[P]` shares come back to
the host, once a level. Each aggregator runs on its own CUDA stream and
counts its own kernel launches (`launches`), so two parties in one
process queue and count apart. There is no mesh: the key-sharded sum is
not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..capacity.model import CapacityModel, default_capacity_model
from ..dpf import BatchCutState, DistributedPointFunction, HostKeyBatch
from ..observability import costmodel as costmodel_mod
from ..observability.device import default_telemetry, shape_key
from ..ops import cuda_lib
from ..value_types import IntType


def frontier_budget_bytes() -> int:
    """Byte budget of one level chunk (the process's capacity model)."""
    return default_capacity_model().frontier_budget_bytes()


def lane_bytes(walk_levels: int, value_blocks: int) -> int:
    """Modeled live device bytes per (key, prefix) lane of one chunk."""
    return default_capacity_model().hh_lane_bytes(walk_levels, value_blocks)


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Resolved chunking decision for one level's frontier evaluation."""

    num_keys: int
    num_prefixes: int
    walk_levels: int
    chunk_prefixes: int  # power of two
    num_chunks: int
    lane_bytes: int
    bytes_peak: int  # modeled peak for one chunk
    budget_bytes: int


def plan_level(
    num_keys: int,
    num_prefixes: int,
    walk_levels: int,
    value_blocks: int,
    budget_bytes: Optional[int] = None,
    model: Optional[CapacityModel] = None,
) -> LevelPlan:
    """Thin client of `CapacityModel.plan_hh_level` (`model`, else the
    process's): the largest power-of-two prefix chunk whose modeled bytes
    fit the budget."""
    model = default_capacity_model() if model is None else model
    chunking = model.plan_hh_level(
        num_keys, num_prefixes, walk_levels, value_blocks,
        budget_bytes=budget_bytes,
    )
    return LevelPlan(
        num_keys=num_keys,
        num_prefixes=num_prefixes,
        walk_levels=walk_levels,
        chunk_prefixes=chunking.chunk_prefixes,
        num_chunks=chunking.num_chunks,
        lane_bytes=chunking.lane_bytes,
        bytes_peak=chunking.bytes_peak,
        budget_bytes=chunking.budget_bytes,
    )


def _peak_bytes(telemetry) -> int:
    """The allocator's peak device bytes (0 on the CPU): its growth across
    a level is the cost ledger's peak-bytes truth whenever the level set
    a new peak."""
    return int(telemetry.hbm.export()["peak_bytes"])


class LevelAggregator:
    """Per-level batched share aggregation with cut-state caching.

    `evaluate_level(l, frontier)` returns this server's additive share of
    the per-prefix count histogram (uint32 mod `2^bits`, one entry per
    frontier prefix) and caches the level's `BatchCutState` so the next
    level resumes from it. Levels ascend within one sweep; `reset()`
    starts a fresh sweep over the same staged keys. `plans` are the
    `LevelPlan`s of the sweep's levels so far, in order.

    Counts use an additive `IntType` of at most 32 bits (one limb), so the
    key-axis sum is one reduction whose wrap-around is the group law.
    """

    def __init__(
        self,
        dpf: DistributedPointFunction,
        keys,
        budget_bytes: Optional[int] = None,
        metrics=None,
        capacity_model: Optional[CapacityModel] = None,
    ):
        vts = {p.value_type for p in dpf.parameters}
        if len(vts) != 1:
            raise ValueError(
                "heavy-hitters hierarchies use one value type at every level"
            )
        vt = next(iter(vts))
        if not isinstance(vt, IntType) or vt.nlimbs != 1:
            raise ValueError(
                f"count aggregation needs an additive IntType of <= 32 bits, got {vt}"
            )
        self._dpf = dpf
        self._mask = (1 << vt.bits) - 1
        dev = dpf._dev()
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._launches: dict = {}
        with self._on_stream():
            self._staged = dpf.stage_key_batch(
                keys if isinstance(keys, HostKeyBatch) else list(keys))
        if self._stream is not None:
            self._stream.synchronize()
        self._budget = budget_bytes
        self._model = capacity_model
        self._metrics = metrics
        self._cuts: Optional[BatchCutState] = None
        self._prev_level = -1
        self.plans: List[LevelPlan] = []

    @contextlib.contextmanager
    def _on_stream(self):
        """This aggregator's stream as the current one, its launches
        counted into `launches`."""
        with contextlib.ExitStack() as stack:
            if self._stream is not None:
                stack.enter_context(torch.cuda.stream(self._stream))
            stack.enter_context(cuda_lib.counting_into(self._launches))
            yield

    @property
    def num_keys(self) -> int:
        return self._staged.n

    @property
    def cuts(self) -> Optional[BatchCutState]:
        return self._cuts

    @property
    def staged(self):
        """The staged key batch (`dpf.StagedKeyBatch`) on the device."""
        return self._staged

    @property
    def launches(self) -> dict:
        """Kernel launches of this aggregator's evaluations so far."""
        return cuda_lib.read_counts(self._launches)

    def reset(self) -> None:
        """Drop cached cut states; the next call may start at any level."""
        self._cuts = None
        self._prev_level = -1
        self.plans = []

    def evaluate_level(
        self, hierarchy_level: int, prefixes: Sequence[int]
    ) -> np.ndarray:
        """This server's share of the count histogram over `prefixes`
        (strictly ascending domain indices at `hierarchy_level`)."""
        if hierarchy_level <= self._prev_level:
            raise ValueError(
                f"levels must ascend within a sweep (got {hierarchy_level} "
                f"after {self._prev_level}; reset() starts a new sweep)"
            )
        prefixes = [int(p) for p in prefixes]
        cuts = self._cuts
        resume = cuts is not None and cuts.hierarchy_level < hierarchy_level
        h2t = self._dpf._hierarchy_to_tree
        stop = h2t[hierarchy_level]
        start = h2t[cuts.hierarchy_level] if resume else 0
        blocks = self._dpf._blocks_needed[hierarchy_level]
        model = default_capacity_model() if self._model is None else self._model
        plan = plan_level(self._staged.n, len(prefixes), stop - start, blocks,
                          self._budget, model)
        self.plans.append(plan)
        if self._metrics is not None:
            self._metrics.counter(
                "hh.cut_resume_prefixes" if resume else "hh.root_eval_prefixes"
            ).inc(len(prefixes))
            self._metrics.counter("hh.level_chunks").inc(plan.num_chunks)

        telemetry = default_telemetry()
        peak_before = _peak_bytes(telemetry)
        t_level = time.perf_counter()
        kw = self._staged.ctrl.shape[0]
        with self._on_stream():
            if plan.num_chunks > 1:
                # The level's cut states, every chunk's written in place.
                dev = self._staged.ctrl.device
                state = torch.empty((16, 8, len(prefixes) * kw), dtype=torch.int32,
                                    device=dev)
                ctrl = torch.empty((len(prefixes) * kw,), dtype=torch.int32, device=dev)
            shares = []
            for c in range(plan.num_chunks):
                lo = c * plan.chunk_prefixes
                chunk = prefixes[lo:lo + plan.chunk_prefixes]
                # One dispatch shape: (levels walked, chunk width, value
                # blocks, resume or root); the short last chunk is its own.
                chunk_key = shape_key(("l", stop - start), ("p", len(chunk)),
                                      ("b", blocks), ("r", int(resume)))
                with telemetry.compile_tracker.dispatch("hh.level", chunk_key):
                    values, cut = self._dpf.evaluate_prefixes_batch(
                        self._staged, hierarchy_level, chunk,
                        cuts=cuts if resume else None)
                    # [num_keys, chunk] one-limb values: the key-axis sum.
                    shares.append(values[..., 0].sum(dim=0))
                del values
                if plan.num_chunks > 1:
                    cols = slice(lo * kw, (lo + len(chunk)) * kw)
                    state[..., cols] = cut.state
                    ctrl[cols] = cut.ctrl
                    del cut
            merged = (cut if plan.num_chunks == 1 else
                      BatchCutState.build(hierarchy_level, prefixes, state, ctrl,
                                          self._staged.n))
            with telemetry.hbm.phase("cut_state_cache"):
                self._cuts = merged
                del cuts
            total = (torch.cat(shares) & self._mask).cpu().numpy()
        self._prev_level = hierarchy_level
        # The level's wall time (the copy above synchronized this stream)
        # against the capacity model's price, into the cost ledger.
        level_ms = (time.perf_counter() - t_level) * 1e3
        predicted = model.price_hh_level(
            self._staged.n, len(prefixes), stop - start, blocks)
        costmodel_mod.default_cost_ledger().observe(
            "hh",
            "resume" if resume else "root",
            costmodel_mod.shape_bucket(predicted.quantity),
            predicted_device_ms=predicted.device_ms,
            actual_device_ms=level_ms,
            predicted_bytes=plan.bytes_peak,
            actual_bytes=max(0, _peak_bytes(telemetry) - peak_before),
        )
        return total.astype(np.uint32)

