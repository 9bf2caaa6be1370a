"""The byte and time models of the port's serving work: the JAX
package's `capacity/model.py`, counted for this port. Dense PIR's
selection bytes (`CapacityModel`, JAX `:322-591`) and the heavy-hitters
half (JAX `:136-320`, `:506-517`, `:593-629`, `:654-657`, `:711-730`):
the frontier budget, the lane bytes of one level chunk, the chunking
plan, and the pricing of a level in device-ms from a calibrated rate.

Dense PIR:

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
CPU).

Heavy hitters: one level evaluates every key at every frontier prefix,
`[keys, prefixes]` lanes, in chunks of prefixes. `hh_lane_bytes` counts
what one chunk of `dpf.evaluate_prefixes_batch` holds per lane at its
peak (keys padded to 32); `plan_hh_level` takes the largest power-of-two
chunk whose lanes fit the frontier budget: an explicit
`frontier_budget`, else 1/64 of the card's memory (the JAX package's
fraction), else 256 MiB on the CPU. The cut states the aggregator keeps
between levels are not lane bytes: they are counted apart
(`dpf.BatchCutState.nbytes`). `price_hh_level` prices a level at the
calibrated lanes/s: the newest clean record of
`heavy_hitters_sweep_lanes_per_sec` in a history file the caller names
(`ThroughputCalibration(history_path)`, in `calibration.py`: the file
reader, whose malformed lines are skipped, stays out of this module),
else the card's rate measured by `chip_smoke.py`.

Serving admission (JAX `:302-760`): `price_pir_keys` prices a request
of dense-PIR keys in device-ms at the calibrated closed-loop serving
q/s (`serving_closed_loop_queries_per_sec` in the history file, else the
card's own rate that `chip_smoke.py`'s `serving` phase measured), and
its byte peak as the materialized tier's selection bytes over the
covering tree (the planner's count). `price_sparse_pir_keys` prices a
sparse request: the JAX package's device-ms (two inner products a key
there) and the byte peak of the port's one staging of bucket rows,
which is one selection matrix over the bucket blocks, as a dense
price. An installed correction provider (`set_correction_provider`,
`recalibrate.py`) multiplies each priced device-ms; it must not raise.
`misprice` (a constructor argument, `{workload: factor}`) multiplies a
workload's price for accuracy drills, where the JAX package reads an
environment variable. No environment variable is read. The serving
mesh (`configure_mesh` and the per-shard prices) waits for the port's
multi-device slice.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

from ..device import device_memory_bytes as probe_device_memory
from .calibration import ThroughputCalibration

_SELECTION_BLOCK_BYTES = 16
_DEFAULT_SELECTION_BUDGET = 1 << 30  # 1 GiB
_DEFAULT_FRONTIER_BUDGET = 1 << 28  # 256 MiB
# Selection tensors get 1/16 of known device memory: the database, cut
# states and scratch share the rest; the heavy-hitters frontier 1/64 (the
# JAX package's fractions).
_SELECTION_MEMORY_FRACTION = 16
_FRONTIER_MEMORY_FRACTION = 64

# The heavy-hitters sweep's lanes/s on the card where no history record
# calibrates it: `chip_smoke.py`'s `heavy_hitters` phase at 65,536
# clients over 64-bit values, one party's 340,787,200 lanes over the
# Leader/Helper session's 1.008 s, on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit.
HH_LANES_PER_SEC_FALLBACK = 337_949_863.0
_HH_LANES_METRIC = "heavy_hitters_sweep_lanes_per_sec"
# The serving sessions' closed-loop q/s on the card where no history
# record calibrates it: `chip_smoke.py`'s `serving` phase (one-query
# requests from 64 clients over TCP loopback to a Leader and a Helper
# at 2^20 x 256 B: 116.44 q/s), on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit.
SERVING_QPS_FALLBACK = 116.44
_SERVING_QPS_METRIC = "serving_closed_loop_queries_per_sec"


def padded_keys(num_keys: int) -> int:
    """The key count the expansion runs: a multiple of 32."""
    return -(-num_keys // 32) * 32


@dataclasses.dataclass(frozen=True)
class WorkCost:
    """Price of one unit of work."""

    bytes_peak: int  # modeled peak live device bytes while it runs
    device_ms: float  # estimated device milliseconds
    quantity: int  # atoms it contains (keys, lanes)
    unit: str  # "pir_keys" | "sparse_keys" | "hh_lanes"


@dataclasses.dataclass(frozen=True)
class LevelChunking:
    """Resolved prefix chunking of one heavy-hitters level."""

    chunk_prefixes: int  # power of two
    num_chunks: int
    lane_bytes: int
    bytes_peak: int  # modeled peak of one chunk
    budget_bytes: int


class CapacityModel:
    """Selection bytes of each dense-PIR tier against a budget, the
    heavy-hitters frontier's lane bytes and chunking, and the prices of
    serving requests and heavy-hitters levels.

    `device_memory_bytes` pins the memory the budgets derive from (None:
    the card's, or none on the CPU); `misprice` multiplies a workload's
    priced device-ms (`{"pir": 2.0}`; drills only)."""

    def __init__(self, selection_budget: Optional[int] = None,
                 frontier_budget: Optional[int] = None,
                 calibration: Optional[ThroughputCalibration] = None,
                 device_memory_bytes: Optional[int] = None,
                 misprice: Optional[Dict[str, float]] = None):
        self._device_memory = (device_memory_bytes if device_memory_bytes is not None
                               else probe_device_memory())
        self._selection_budget = selection_budget
        self._frontier_budget = frontier_budget
        self.calibration = calibration if calibration is not None else ThroughputCalibration()
        self._misprice = dict(misprice or {})
        # `fn(workload, quantity) -> factor` multiplying each priced
        # device-ms (`recalibrate.Recalibrator.correction`); None prices raw.
        self._correction: Optional[Callable[[str, int], float]] = None
        # The replica label of the price exports (None outside a fleet).
        self._replica: Optional[str] = None

    # -- replica identity and the correction hook ---------------------------

    def set_replica(self, replica_id: Optional[str]) -> None:
        """Label this model's exports with a replica id (None clears it)."""
        self._replica = str(replica_id) if replica_id is not None else None

    @property
    def replica_id(self) -> Optional[str]:
        return self._replica

    def set_correction_provider(
        self, provider: Optional[Callable[[str, int], float]]
    ) -> None:
        """Install (or, with None, remove) the recalibration correction
        provider. It must be cheap and must not raise: a price has no
        fallback."""
        self._correction = provider

    def misprice_factor(self, workload: str) -> float:
        """The drill multiplier of `workload` (1.0 unless `misprice` set one)."""
        return self._misprice.get(workload, 1.0)

    def _corrected(self, workload: str, quantity: int, device_ms: float) -> float:
        """A raw device-ms estimate times the drill multiplier and the
        installed correction factor."""
        device_ms *= self.misprice_factor(workload)
        provider = self._correction
        if provider is not None:
            device_ms *= float(provider(workload, quantity))
        return device_ms

    @property
    def device_memory_bytes(self) -> Optional[int]:
        return self._device_memory

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


    # -- heavy-hitters frontier bytes and price ---------------------------

    def frontier_budget_bytes(self) -> int:
        """The byte budget of one heavy-hitters level chunk: the explicit
        one, else 1/64 of known device memory, else 256 MiB."""
        if self._frontier_budget is not None:
            return max(1, int(self._frontier_budget))
        if self._device_memory is not None:
            return max(1, self._device_memory // _FRONTIER_MEMORY_FRACTION)
        return _DEFAULT_FRONTIER_BUDGET

    def hh_lane_bytes(self, walk_levels: int, value_blocks: int) -> int:
        """Device bytes one (key, prefix) lane of a level chunk holds at
        its peak, 16 a 128-bit block (planes or limbs), counted from the
        tensors `dpf.evaluate_prefixes_batch` keeps alive: the walk's
        input and output states (32), a packed path word per level walked
        and the input and output control words ((walk_levels + 2) / 8);
        for a one-block value, the walk's output (the chunk's cut state:
        16, and 1/8 of packed control), K3's output (16) and the widest
        moment of its `planes_to_limbs` (56: a contiguous copy, the halves
        of a transpose round and its result); for B > 1 blocks the seeds'
        limbs and the B blocks stacked, padded, in planes, hashed and
        transposed back (33 + 136 B). The larger stage is the peak,
        rounded up to whole bytes."""
        walk = 32 + -(-(walk_levels + 2) // 8)
        value = 89 if value_blocks == 1 else 33 + 136 * value_blocks
        return max(walk, value)

    def plan_hh_level(self, num_keys: int, num_prefixes: int, walk_levels: int,
                      value_blocks: int, budget_bytes: Optional[int] = None
                      ) -> LevelChunking:
        """The largest power-of-two prefix chunk whose lanes (keys padded
        to 32) fit the budget; at least one prefix. Chunked evaluation
        equals unchunked: lanes are independent."""
        budget = self.frontier_budget_bytes() if budget_bytes is None else budget_bytes
        lb = self.hh_lane_bytes(walk_levels, value_blocks)
        keys = padded_keys(num_keys)
        chunk = 1 << max(0, (max(1, num_prefixes) - 1).bit_length())
        while chunk > 1 and keys * chunk * lb > budget:
            chunk //= 2
        return LevelChunking(chunk_prefixes=chunk, num_chunks=-(-num_prefixes // chunk),
                             lane_bytes=lb, bytes_peak=keys * chunk * lb,
                             budget_bytes=budget)

    def hh_lanes_per_sec(self) -> float:
        return self.calibration.throughput(_HH_LANES_METRIC, HH_LANES_PER_SEC_FALLBACK)

    # -- serving prices -------------------------------------------------------

    def serving_queries_per_sec(self) -> float:
        """Calibrated closed-loop serving q/s: the denominator of
        admission's queue-drain estimate."""
        return self.calibration.throughput(_SERVING_QPS_METRIC, SERVING_QPS_FALLBACK)

    def _selection_peak(self, num_keys: int, num_blocks: Optional[int]) -> int:
        """The materialized tier's selection bytes over the covering tree
        (0 without a database geometry)."""
        if not num_blocks:
            return 0
        leaves = max(num_blocks, 1 << max(0, (num_blocks - 1).bit_length()))
        return self.materialized_selection_bytes(num_keys, num_blocks, leaves)

    def price_pir_keys(self, num_keys: int, num_blocks: Optional[int] = None) -> WorkCost:
        """Price a serving request of `num_keys` dense-PIR keys: the
        materialized tier's selection bytes when the geometry is known
        (the tier with the largest peak), device-ms at the calibrated
        serving q/s."""
        qps = max(1e-6, self.serving_queries_per_sec())
        return WorkCost(
            bytes_peak=self._selection_peak(num_keys, num_blocks),
            device_ms=self._corrected("pir", num_keys, num_keys * 1e3 / qps),
            quantity=num_keys, unit="pir_keys")

    def price_sparse_pir_keys(self, num_keys: int,
                              num_blocks: Optional[int] = None) -> WorkCost:
        """Price a sparse (cuckoo key-value) request of `num_keys` DPF
        keys over the bucket blocks: device-ms as the JAX package prices
        it (twice a dense key's), the byte peak of the port's one
        selection matrix over its one staging of bucket rows. Corrections
        key on the "sparse" workload, apart from dense ones."""
        qps = max(1e-6, self.serving_queries_per_sec())
        return WorkCost(
            bytes_peak=self._selection_peak(num_keys, num_blocks),
            device_ms=self._corrected("sparse", num_keys, 2.0 * num_keys * 1e3 / qps),
            quantity=num_keys, unit="sparse_keys")

    def price_export(self, num_keys: int = 8, num_blocks: Optional[int] = None) -> dict:
        """The replica's price card: one `price_pir_keys` probe at a small
        batch, per key, and the q/s it derives from."""
        cost = self.price_pir_keys(num_keys, num_blocks)
        return {
            "replica": self._replica,
            "probe_keys": int(num_keys),
            "device_ms": round(cost.device_ms, 4),
            "device_ms_per_key": round(cost.device_ms / max(1, num_keys), 5),
            "bytes_peak": cost.bytes_peak,
            "queries_per_sec": round(self.serving_queries_per_sec(), 2),
        }

    def export(self) -> dict:
        """The model's state: budgets, calibrated rates, calibration."""
        return {
            "replica": self._replica,
            "device_memory_bytes": self._device_memory,
            "selection_budget_bytes": self.selection_budget_bytes(),
            "frontier_budget_bytes": self.frontier_budget_bytes(),
            "serving_queries_per_sec": round(self.serving_queries_per_sec(), 2),
            "hh_lanes_per_sec": round(self.hh_lanes_per_sec(), 2),
            "misprice": dict(sorted(self._misprice.items())),
            "calibration": self.calibration.export(),
        }

    def price_hh_level(self, num_keys: int, num_prefixes: int, walk_levels: int,
                       value_blocks: int) -> WorkCost:
        """Price one heavy-hitters level (`num_keys x num_prefixes`
        lanes): its chunk's modeled peak and device-ms at the calibrated
        lanes/s."""
        chunking = self.plan_hh_level(num_keys, num_prefixes, walk_levels, value_blocks)
        lanes = num_keys * num_prefixes
        lps = max(1e-6, self.hh_lanes_per_sec())
        return WorkCost(bytes_peak=chunking.bytes_peak,
                        device_ms=self._corrected("hh", lanes, lanes * 1e3 / lps),
                        quantity=lanes, unit="hh_lanes")


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
