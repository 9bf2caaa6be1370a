"""Workload observatory: bounded-memory traffic characterization,
copied from the JAX package's `observability/workload.py` (the same
seeded hashing, so the same observations give the same export).

Real PIR populations are Zipfian, diurnal and bursty. This module characterizes the *live*
request stream per tenant on the hot path, in O(1) memory, so the
forecast plane (the JAX package's `observability/forecast.py`) and the predictive
admission governor have something real to extrapolate from:

* `CountMinSketch` — frequency estimates over public key indices with
  a fixed `width x depth` grid of counters (estimates only ever
  overshoot, by at most ~`total/width` per row with high probability).
* `TopKTracker` — space-saving heavy-hitter tracker: the K hottest
  keys with per-entry overestimation error, agreeing with an exact
  oracle on genuinely skewed streams.
* `fit_zipf_exponent` — online Zipf fit: least-squares slope of
  log(count) vs log(rank) over the top-K table, so "how skewed is
  today's traffic" is one number an operator (or the capacity model)
  can read.
* `WorkloadObservatory` — the composite: sketch + top-K + per-tenant
  EWMA arrival rate and CV² burstiness + bounded deadline/batch-size
  histograms + periodicity detection over the TSDB's coarse tier,
  exported at `/workloadz` and as registry gauges.

Privacy note: in the two-party deployment the DPF keys *hide* the
queried index from each server — that is the protocol's entire point —
so a serving hot path can only ever observe volume, batch size,
tenant, and deadline. Key indices reach the sketch only where they are
legitimately public: trusted/plain single-server deployments, the
client-side front door, or synthetic load generators. `observe()`
therefore takes `key_indices=None` and characterizes what it is given.

Memory is budgeted, not hoped for: the sketch grid, the top-K table,
the tenant map (overflow tenants lump into `__other__`), and the
fixed-bound histograms are all constant-size; `approx_bytes()` is
asserted against `byte_budget` by tests and surfaced in the export.

Layering: stdlib + same-package modules only (the registry and the
TSDB arrive duck-typed).
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CountMinSketch",
    "TopKTracker",
    "WorkloadObservatory",
    "detect_periodicity",
    "fit_zipf_exponent",
]

# Fixed histogram bounds (ms / keys). Constant size by construction.
DEADLINE_BUCKETS_MS = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                       1000.0, 2500.0)
BATCH_BUCKETS_KEYS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

_PRIME = (1 << 61) - 1  # Mersenne prime for multiply-shift hashing


class CountMinSketch:
    """Count–min sketch over integer keys (deterministic, seeded).

    `depth` rows of `width` counters; `add` increments one counter per
    row, `estimate` takes the row-wise min. Estimates never undershoot
    and overshoot by at most `e * total / width` per row with
    probability `1 - e^-depth` — the classic Cormode–Muthukrishnan
    bound, asserted (with slack) by the adversarial-flood test.
    """

    def __init__(self, width: int = 1024, depth: int = 4, seed: int = 0):
        if width < 8 or depth < 1:
            raise ValueError("width must be >= 8 and depth >= 1")
        self.width = int(width)
        self.depth = int(depth)
        rng = random.Random(seed)
        # Pairwise-independent multiply-shift rows: h(x) = (a*x+b) mod p
        # mod width, a odd and nonzero so distinct keys spread.
        self._rows_ab = [
            (rng.randrange(1, _PRIME) | 1, rng.randrange(0, _PRIME))
            for _ in range(self.depth)
        ]
        self._counts = [[0] * self.width for _ in range(self.depth)]
        self.total = 0

    def _index(self, row: int, key: int) -> int:
        a, b = self._rows_ab[row]
        return ((a * (int(key) + 1) + b) % _PRIME) % self.width

    def add(self, key: int, count: int = 1) -> None:
        for row in range(self.depth):
            self._counts[row][self._index(row, key)] += count
        self.total += count

    def estimate(self, key: int) -> int:
        return min(
            self._counts[row][self._index(row, key)]
            for row in range(self.depth)
        )

    def error_bound(self) -> float:
        """The per-estimate overshoot ceiling `e * total / width` (holds
        with probability `1 - e^-depth`)."""
        return math.e * self.total / self.width

    def approx_bytes(self) -> int:
        # 8 logical bytes per counter plus per-row bookkeeping.
        return self.width * self.depth * 8 + self.depth * 64

    def export(self) -> dict:
        nonzero = sum(
            1 for row in self._counts for c in row if c
        )
        return {
            "width": self.width,
            "depth": self.depth,
            "total": self.total,
            "fill_pct": round(
                nonzero / (self.width * self.depth) * 100.0, 2
            ),
            "error_bound": round(self.error_bound(), 2),
        }


class TopKTracker:
    """Space-saving top-K heavy hitters over integer keys.

    At most `k` entries ever exist. A new key past capacity evicts the
    current minimum and inherits its count as `error` (the classic
    Metwally et al. bound: a key's true count is within `error` below
    the tracked count). On skewed streams the table converges to the
    true heavy hitters — asserted against an exact oracle in tests.
    """

    def __init__(self, k: int = 32):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)
        # key -> [count, error]
        self._entries: Dict[int, List[int]] = {}

    def add(self, key: int, count: int = 1) -> None:
        key = int(key)
        entry = self._entries.get(key)
        if entry is not None:
            entry[0] += count
            return
        if len(self._entries) < self.k:
            self._entries[key] = [count, 0]
            return
        evict_key, evict_entry = min(
            self._entries.items(), key=lambda kv: kv[1][0]
        )
        floor = evict_entry[0]
        del self._entries[evict_key]
        self._entries[key] = [floor + count, floor]

    def items(self) -> List[Tuple[int, int, int]]:
        """[(key, count, error)] sorted by count descending."""
        return sorted(
            ((k, c, e) for k, (c, e) in self._entries.items()),
            key=lambda kce: (-kce[1], kce[0]),
        )

    def __len__(self) -> int:
        return len(self._entries)

    def approx_bytes(self) -> int:
        return self.k * 96


def fit_zipf_exponent(
    counts: Sequence[float], min_points: int = 3
) -> Optional[float]:
    """Least-squares Zipf exponent from rank-ordered counts.

    Fits `log(count) = c - s * log(rank)` over ranks 1..n and returns
    `s` (1.0 ~ classic Zipf, 0 ~ uniform). None when there are fewer
    than `min_points` positive counts or no spread to fit."""
    ranked = [float(c) for c in counts if c > 0]
    if len(ranked) < max(2, min_points):
        return None
    xs = [math.log(r + 1) for r in range(len(ranked))]
    ys = [math.log(c) for c in ranked]
    n = len(xs)
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    var_x = sum((x - mean_x) ** 2 for x in xs)
    if var_x <= 1e-12:
        return None
    cov = sum(
        (x - mean_x) * (y - mean_y) for x, y in zip(xs, ys)
    )
    return round(max(0.0, -cov / var_x), 4)


def detect_periodicity(
    values: Sequence[Optional[float]],
    step_s: float,
    min_lag: int = 2,
    min_strength: float = 0.4,
) -> Optional[dict]:
    """Dominant period via autocorrelation over aligned samples.

    `values` are step-aligned (None = gap, filled with the mean so a
    sparse window does not fake a cycle). Returns
    `{"period_s", "strength", "lag"}` when the best autocorrelation at
    lag >= `min_lag` clears `min_strength`, else None."""
    xs = [v for v in values if v is not None]
    if len(xs) < 8:
        return None
    mean = sum(xs) / len(xs)
    filled = [v if v is not None else mean for v in values]
    centered = [v - mean for v in filled]
    denom = sum(c * c for c in centered)
    if denom <= 1e-12:
        return None
    n = len(centered)
    best_lag, best_r = None, 0.0
    for lag in range(min_lag, n // 2 + 1):
        num = sum(
            centered[i] * centered[i - lag] for i in range(lag, n)
        )
        r = num / denom
        if r > best_r:
            best_lag, best_r = lag, r
    if best_lag is None or best_r < min_strength:
        return None
    return {
        "period_s": round(best_lag * step_s, 3),
        "strength": round(best_r, 4),
        "lag": best_lag,
    }


class _ArrivalStats:
    """EWMA inter-arrival estimator: rate (1/EWMA dt) and CV²
    burstiness (EWMA variance / EWMA mean², ~1 for Poisson, >>1 for
    bursts, <<1 for a metronome)."""

    __slots__ = ("alpha", "last_t", "ewma_dt", "ewma_dt2", "observations",
                 "keys")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.last_t: Optional[float] = None
        self.ewma_dt: Optional[float] = None
        self.ewma_dt2: Optional[float] = None
        self.observations = 0
        self.keys = 0

    def observe(self, now: float, num_keys: int) -> None:
        self.observations += 1
        self.keys += num_keys
        if self.last_t is not None:
            dt = max(1e-6, now - self.last_t)
            if self.ewma_dt is None:
                self.ewma_dt = dt
                self.ewma_dt2 = dt * dt
            else:
                a = self.alpha
                self.ewma_dt = (1 - a) * self.ewma_dt + a * dt
                self.ewma_dt2 = (1 - a) * self.ewma_dt2 + a * dt * dt
        self.last_t = now

    def rate_qps(self) -> Optional[float]:
        if self.ewma_dt is None or self.ewma_dt <= 0:
            return None
        return round(1.0 / self.ewma_dt, 4)

    def cv2(self) -> Optional[float]:
        if self.ewma_dt is None or self.ewma_dt <= 0:
            return None
        var = max(0.0, self.ewma_dt2 - self.ewma_dt * self.ewma_dt)
        return round(var / (self.ewma_dt * self.ewma_dt), 4)

    def export(self) -> dict:
        return {
            "observations": self.observations,
            "keys": self.keys,
            "rate_qps": self.rate_qps(),
            "burstiness_cv2": self.cv2(),
        }


def _bucketize(bounds: Sequence[float], counts: List[int],
               value: float) -> None:
    for i, bound in enumerate(bounds):
        if value <= bound:
            counts[i] += 1
            return
    counts[-1] += 1


class WorkloadObservatory:
    """Per-tenant hot-path traffic characterization in bounded memory.

    `observe()` is the hot-path entry (a few dict lookups, sketch row
    updates only when indices are supplied); everything else is
    read-side. The tenant map is capped at `max_tenants` — overflow
    tenants aggregate into `__other__` so a tenant-name flood cannot
    grow memory. `store`/`period_series` opt into periodicity detection
    over the TSDB's coarsest tier.
    """

    OVERFLOW_TENANT = "__other__"

    def __init__(
        self,
        *,
        sketch_width: int = 1024,
        sketch_depth: int = 4,
        top_k: int = 32,
        max_tenants: int = 16,
        ewma_alpha: float = 0.1,
        byte_budget: int = 256 * 1024,
        store=None,
        period_series: str = "workload.rate_qps",
        registry=None,
        name: str = "workload",
        clock=time.monotonic,
        seed: int = 0,
    ):
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.sketch = CountMinSketch(sketch_width, sketch_depth, seed=seed)
        self.topk = TopKTracker(top_k)
        self._alpha = min(1.0, max(1e-3, float(ewma_alpha)))
        self._max_tenants = int(max_tenants)
        self._byte_budget = int(byte_budget)
        self._store = store
        self._period_series = period_series
        self._name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._total = _ArrivalStats(self._alpha)
        self._tenants: Dict[str, _ArrivalStats] = {}
        self._deadline_counts = [0] * (len(DEADLINE_BUCKETS_MS) + 1)
        self._deadline_n = 0
        self._batch_counts = [0] * (len(BATCH_BUCKETS_KEYS) + 1)
        self._registry = registry
        self._gauges = {}

    # -- hot path ------------------------------------------------------------

    def observe(
        self,
        num_keys: int = 1,
        tenant: str = "default",
        key_indices: Optional[Sequence[int]] = None,
        deadline_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """Record one request: `num_keys` keys for `tenant`, optionally
        the public key indices (trusted/front-door contexts only — see
        the module docstring) and the *relative* deadline in seconds."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._total.observe(now, num_keys)
            stats = self._tenants.get(tenant)
            if stats is None:
                if len(self._tenants) >= self._max_tenants:
                    tenant = self.OVERFLOW_TENANT
                    stats = self._tenants.get(tenant)
                if stats is None:
                    stats = _ArrivalStats(self._alpha)
                    self._tenants[tenant] = stats
            stats.observe(now, num_keys)
            _bucketize(BATCH_BUCKETS_KEYS, self._batch_counts,
                       float(num_keys))
            if deadline_s is not None:
                _bucketize(
                    DEADLINE_BUCKETS_MS, self._deadline_counts,
                    max(0.0, float(deadline_s)) * 1e3,
                )
                self._deadline_n += 1
            if key_indices:
                for index in key_indices:
                    self.sketch.add(int(index))
                    self.topk.add(int(index))

    # -- read side -----------------------------------------------------------

    def hot_share_pct(self) -> Optional[float]:
        """Share of all sketched key observations covered by the top-K
        table (error-corrected lower bound)."""
        if self.sketch.total <= 0:
            return None
        covered = sum(
            max(0, count - error) for _, count, error in self.topk.items()
        )
        return round(
            min(100.0, covered / self.sketch.total * 100.0), 2
        )

    def zipf_exponent(self) -> Optional[float]:
        # Fit only majority-observed entries, error-corrected: a
        # space-saving count includes the floor inherited at eviction,
        # which inflates the tail and flattens the slope (raw counts
        # underestimate s); churny entries that are mostly inherited
        # floor carry no rank information and oversteepen it the other
        # way. `count - error > error` keeps the stable head, where
        # `count - error` is the guaranteed-observed portion.
        return fit_zipf_exponent([
            count - error
            for _, count, error in self.topk.items()
            if count - error > error
        ])

    def periodicity(self, now: Optional[float] = None) -> Optional[dict]:
        """Dominant arrival-rate period from the TSDB's coarsest tier
        (None without a store or enough history)."""
        if self._store is None:
            return None
        if now is None:
            now = self._clock()
        tiers = getattr(self._store, "tiers", None)
        if not tiers:
            return None
        tier = len(tiers) - 1
        step_s, slots = tiers[tier]
        step_s, samples = self._store.query_range(
            self._period_series, now - step_s * slots, now, tier=tier,
            now=now,
        )
        return detect_periodicity(
            [v for _, v in samples], step_s
        )

    def approx_bytes(self) -> int:
        """Logical resident footprint (same accounting convention as
        `TimeSeriesStore.approx_bytes`): sketch grid + top-K table +
        tenant stats + fixed histograms."""
        with self._lock:
            tenants = len(self._tenants)
        return (
            self.sketch.approx_bytes()
            + self.topk.approx_bytes()
            + (tenants + 1) * 160
            + (len(self._deadline_counts) + len(self._batch_counts)) * 16
        )

    @property
    def byte_budget(self) -> int:
        return self._byte_budget

    def bind_registry(self, registry) -> None:
        """Mirror the headline characterization into `registry` gauges
        (refreshed on every `export()`/`gauge_source()` read)."""
        self._registry = registry

    def gauge_source(self) -> Dict[str, float]:
        """`{series: value}` for a `MetricsSampler` extra source — the
        observatory's headline numbers become TSDB series (and registry
        gauges when bound) without the sampler knowing about workloads."""
        with self._lock:
            rate = self._total.rate_qps()
            cv2 = self._total.cv2()
            observations = self._total.observations
        out: Dict[str, float] = {}
        if rate is not None:
            out[f"{self._name}.rate_qps"] = rate
        if cv2 is not None:
            out[f"{self._name}.burstiness_cv2"] = cv2
        zipf = self.zipf_exponent()
        if zipf is not None:
            out[f"{self._name}.zipf_exponent"] = zipf
        hot = self.hot_share_pct()
        if hot is not None:
            out[f"{self._name}.hot_share_pct"] = hot
        out[f"{self._name}.observations"] = float(observations)
        out[f"{self._name}.observatory_bytes"] = float(self.approx_bytes())
        if self._registry is not None:
            for series, value in out.items():
                self._registry.gauge(series).set(value)
        return out

    def export(self, now: Optional[float] = None) -> dict:
        """The `/workloadz` state (refreshes registry gauges when
        bound)."""
        if now is None:
            now = self._clock()
        gauges = self.gauge_source()
        with self._lock:
            total = self._total.export()
            tenants = {
                name: stats.export()
                for name, stats in sorted(self._tenants.items())
            }
            deadline_counts = list(self._deadline_counts)
            deadline_n = self._deadline_n
            batch_counts = list(self._batch_counts)
        observations = total["observations"] or 0
        for name, row in tenants.items():
            row["share_pct"] = round(
                row["observations"] / observations * 100.0, 2
            ) if observations else 0.0
        top = self.topk.items()
        total_sketched = self.sketch.total
        approx = self.approx_bytes()
        return {
            "name": self._name,
            "observations": observations,
            "keys_observed": total["keys"],
            "rate_qps": total["rate_qps"],
            "burstiness_cv2": total["burstiness_cv2"],
            "zipf_exponent": gauges.get(f"{self._name}.zipf_exponent"),
            "hot_share_pct": gauges.get(f"{self._name}.hot_share_pct"),
            "periodicity": self.periodicity(now=now),
            "sketch": self.sketch.export(),
            "top_keys": [
                {
                    "key": key,
                    "count": count,
                    "error": error,
                    "share_pct": round(
                        count / total_sketched * 100.0, 2
                    ) if total_sketched else 0.0,
                }
                for key, count, error in top
            ],
            "tenants": tenants,
            "deadline_ms": {
                "count": deadline_n,
                "buckets": _bucket_export(
                    DEADLINE_BUCKETS_MS, deadline_counts
                ),
            },
            "batch_keys": {
                "count": observations,
                "buckets": _bucket_export(
                    BATCH_BUCKETS_KEYS, batch_counts
                ),
            },
            "approx_bytes": approx,
            "byte_budget": self._byte_budget,
            "within_budget": approx <= self._byte_budget,
        }


def _bucket_export(
    bounds: Sequence[float], counts: Sequence[int]
) -> Dict[str, int]:
    out = {}
    for bound, count in zip(bounds, counts):
        out[f"{bound:g}"] = count
    out["+inf"] = counts[-1]
    return out
