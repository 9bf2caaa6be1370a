"""In-process flight-data recorder: a dependency-free multi-resolution
ring TSDB plus a jittered metrics sampler and a rate-of-change anomaly
watch. Copied from the JAX package's `observability/timeseries.py`
(stdlib and `events` only).

Every operator surface before this module (`/statusz`, `/criticalz`,
debug bundles) is a point-in-time snapshot: by the time someone looks,
the interesting 90 seconds are gone. The `TimeSeriesStore` keeps the
recent past in bounded memory as tiered rings — by default 1 s
resolution for 5 minutes and 10 s resolution for an hour — so an
incident bundle carries the last minutes of history instead of one
frozen instant.

* `TimeSeriesStore` — named series, each a set of fixed-slot rings
  (one per tier). Budgeted two ways: `max_series` caps how many
  distinct series exist (a labeled-metric flood drops new names and
  counts them, it never grows), and the per-tier slot counts are fixed
  at construction, so memory is O(max_series x total_slots) forever.
* `MetricsSampler` — a background thread that snapshots selected
  counters/gauges/histogram-percentiles from a `MetricsRegistry`
  (duck-typed `export()`), plus the utilization tracker's duty-cycle /
  feed-efficiency / bubble totals, into the store at a jittered period
  (so a fleet of processes never thunders in phase). `sample_once()`
  is the deterministic core — tests and the CI smoke drive it with an
  injected clock.
* `AnomalyWatch` — per-series rate-of-change guard: once warmed up, a
  sample spiking above `ratio` x the trailing mean (plus an absolute
  floor) or collapsing below mean/`ratio` journals a coalesced
  `util.anomaly` event into the `EventJournal`.
* `render_sparklines` — terminal-width text rendering (one block-glyph
  sparkline per series) for the `/timeseriesz` admin endpoint.

Layering: stdlib + same-package `events` only; the registry and the
utilization tracker arrive duck-typed from above.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import events as events_mod

__all__ = [
    "DEFAULT_TIERS",
    "AnomalyWatch",
    "MetricsSampler",
    "TimeSeriesStore",
    "render_sparklines",
    "sparkline",
]

# (step_seconds, slots): 1 s x 5 min for incident forensics, 10 s x 1 h
# for trend context. Total 660 slots per series.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = ((1.0, 300), (10.0, 360))

_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


class _Ring:
    """One fixed-resolution ring: slot i holds the last sample whose
    timestamp fell into absolute slot `slot_ids[i]` (write-wins within
    a slot keeps sampling idempotent at any rate)."""

    __slots__ = ("step_s", "slots", "slot_ids", "values")

    def __init__(self, step_s: float, slots: int):
        self.step_s = float(step_s)
        self.slots = int(slots)
        self.slot_ids: List[Optional[int]] = [None] * self.slots
        self.values: List[float] = [0.0] * self.slots

    def put(self, t: float, value: float) -> None:
        slot = int(t // self.step_s)
        i = slot % self.slots
        self.slot_ids[i] = slot
        self.values[i] = value

    def points(self, now: float) -> List[Tuple[float, float]]:
        """(timestamp, value) pairs still inside the ring's horizon,
        oldest first. Slots overwritten by a later lap are naturally
        excluded by the slot-id check."""
        horizon = int(now // self.step_s) - self.slots
        out = [
            (sid * self.step_s, self.values[i])
            for i, sid in enumerate(self.slot_ids)
            if sid is not None and sid >= horizon
        ]
        out.sort()
        return out


class TimeSeriesStore:
    """Bounded multi-resolution store; see module docstring."""

    def __init__(
        self,
        tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
        max_series: int = 128,
        clock=time.monotonic,
    ):
        if not tiers:
            raise ValueError("need at least one tier")
        if max_series < 1:
            raise ValueError("max_series must be >= 1")
        self._tiers = tuple((float(s), int(n)) for s, n in tiers)
        self._max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, List[_Ring]] = {}
        self._dropped_series = 0
        self._samples = 0

    @property
    def tiers(self) -> Tuple[Tuple[float, int], ...]:
        return self._tiers

    @property
    def max_series(self) -> int:
        return self._max_series

    def slot_budget(self) -> int:
        """Hard ceiling on retained samples: series cap x total slots.
        The flood test asserts occupancy never exceeds it."""
        return self._max_series * sum(n for _, n in self._tiers)

    def approx_bytes(self) -> int:
        """Rough resident footprint: two Python floats'-worth of slots
        per ring entry (slot id + value) plus per-series overhead."""
        with self._lock:
            slots = len(self._series) * sum(n for _, n in self._tiers)
        return slots * 16 + len(self._series) * 128

    def record(self, name: str, value: float, t: Optional[float] = None) -> None:
        """Write one sample into every tier; new series past
        `max_series` are dropped (and counted), never grown."""
        if t is None:
            t = self._clock()
        with self._lock:
            rings = self._series.get(name)
            if rings is None:
                if len(self._series) >= self._max_series:
                    self._dropped_series += 1
                    return
                rings = [_Ring(s, n) for s, n in self._tiers]
                self._series[name] = rings
            for ring in rings:
                ring.put(t, float(value))
            self._samples += 1

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(
        self, name: str, tier: int = 0, now: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        """One series' points at one tier, oldest first (empty for an
        unknown name)."""
        if now is None:
            now = self._clock()
        with self._lock:
            rings = self._series.get(name)
            if rings is None or not 0 <= tier < len(rings):
                return []
            return rings[tier].points(now)

    def query_range(
        self,
        name: str,
        start: float,
        end: float,
        tier: Optional[int] = None,
        now: Optional[float] = None,
    ) -> Tuple[float, List[Tuple[float, Optional[float]]]]:
        """Aligned-window accessor: `(step_s, [(t, value-or-None)])`
        covering `[start, end]` on one tier's slot grid.

        Unlike `series()` (live points only, caller re-aligns), this
        returns one entry per slot with `None` marking gaps and
        lap-expired slots — exactly what a forecaster or autocorrelation
        pass needs. `tier=None` picks the finest tier whose horizon
        still covers `start` (falling through to coarser tiers, then
        the coarsest); an explicit tier index is honored as-is. An
        unknown series yields the aligned grid of Nones, not an error,
        so read-side callers never race series creation."""
        if now is None:
            now = self._clock()
        if end < start:
            raise ValueError("end must be >= start")
        with self._lock:
            if tier is None:
                tier = len(self._tiers) - 1
                for i, (step_s, slots) in enumerate(self._tiers):
                    if step_s * slots >= (now - start):
                        tier = i
                        break
            if not 0 <= tier < len(self._tiers):
                raise ValueError(f"tier {tier} out of range")
            step_s, slots = self._tiers[tier]
            rings = self._series.get(name)
            ring = rings[tier] if rings is not None else None
            last_slot = int(end // step_s)
            # Clamp to one ring-length of slots so a huge [start, end]
            # can't loop unboundedly — older slots are gone anyway.
            first_slot = max(
                int(start // step_s), last_slot - slots + 1
            )
            lap_floor = int(now // step_s) - slots
            samples: List[Tuple[float, Optional[float]]] = []
            for sid in range(first_slot, last_slot + 1):
                value: Optional[float] = None
                if ring is not None and sid >= lap_floor:
                    i = sid % slots
                    if ring.slot_ids[i] == sid:
                        value = ring.values[i]
                samples.append((sid * step_s, value))
            return step_s, samples

    def occupancy(self) -> int:
        """Live slots across every series and tier (<= slot_budget)."""
        with self._lock:
            return sum(
                sum(1 for sid in ring.slot_ids if sid is not None)
                for rings in self._series.values()
                for ring in rings
            )

    def export(self, now: Optional[float] = None) -> dict:
        """The whole store, bundle-ready: per-series per-tier points
        plus the budget bookkeeping."""
        if now is None:
            now = self._clock()
        with self._lock:
            series = {
                name: {
                    f"{ring.step_s:g}s": [
                        [round(t, 3), round(v, 6)]
                        for t, v in ring.points(now)
                    ]
                    for ring in rings
                }
                for name, rings in sorted(self._series.items())
            }
            return {
                "tiers": [
                    {"step_s": s, "slots": n} for s, n in self._tiers
                ],
                "max_series": self._max_series,
                "series_count": len(self._series),
                "dropped_series": self._dropped_series,
                "samples": self._samples,
                "now": round(now, 3),
                "series": series,
            }


class AnomalyWatch:
    """Trailing-mean rate-of-change guard over sampled series.

    A series is judged only after `min_samples` history; a new sample
    is anomalous when it exceeds `ratio x mean + floor` (spike) or
    drops below `mean / ratio - floor` while the mean was materially
    above the floor (collapse). Each finding journals one coalesced
    `util.anomaly` event and becomes the new history, so a sustained
    shift alarms once, not every second.

    Near-zero series get an absolute noise floor: the trailing mean is
    judged as at least `min_mean`, and the sample must move at least
    `min_delta` from the mean, so a quiet counter ticking 0 -> 1 (e.g.
    `fleet.spillover` on an idle fleet) is noise, not a 3x spike.
    """

    def __init__(
        self,
        ratio: float = 3.0,
        floor: float = 1.0,
        min_samples: int = 5,
        history: int = 30,
        coalesce_s: float = 30.0,
        journal=None,
        min_mean: float = 1.0,
        min_delta: float = 0.0,
    ):
        if ratio <= 1.0:
            raise ValueError("ratio must be > 1")
        self._ratio = float(ratio)
        self._floor = float(floor)
        self._min_mean = float(min_mean)
        self._min_delta = float(min_delta)
        self._min_samples = int(min_samples)
        self._history = int(history)
        self._coalesce_s = float(coalesce_s)
        self._journal = journal
        self._lock = threading.Lock()
        self._recent: Dict[str, "collectionsdeque"] = {}
        self._anomalies = 0

    def observe(self, name: str, value: float, t: float) -> Optional[dict]:
        """Feed one sample; returns the anomaly record when one fired
        (already journaled), else None."""
        import collections

        with self._lock:
            ring = self._recent.setdefault(
                name, collections.deque(maxlen=self._history)
            )
            warm = len(ring) >= self._min_samples
            mean = (sum(ring) / len(ring)) if ring else 0.0
            ring.append(float(value))
            self._recent[name] = ring
        if not warm:
            return None
        judged_mean = max(mean, self._min_mean)
        spike = (
            value > self._ratio * judged_mean + self._floor
            and (value - mean) >= self._min_delta
        )
        collapse = (
            mean > max(2.0 * self._floor, self._min_mean)
            and value < mean / self._ratio - self._floor
            and (mean - value) >= self._min_delta
        )
        if not spike and not collapse:
            return None
        record = {
            "series": name,
            "value": round(float(value), 6),
            "trailing_mean": round(mean, 6),
            "ratio": self._ratio,
            "direction": "spike" if spike else "collapse",
            "t": round(t, 3),
        }
        with self._lock:
            self._anomalies += 1
        try:
            emit = (
                self._journal.emit
                if self._journal is not None
                else events_mod.emit
            )
            emit(
                "util.anomaly",
                f"{name} {record['direction']}: {record['value']} vs "
                f"trailing mean {record['trailing_mean']}",
                severity="warning",
                coalesce_key=f"util.anomaly:{name}",
                coalesce_s=self._coalesce_s,
                **record,
            )
        except Exception:  # noqa: BLE001 - telemetry never raises
            pass
        return record

    def export(self) -> dict:
        with self._lock:
            return {
                "ratio": self._ratio,
                "floor": self._floor,
                "min_mean": self._min_mean,
                "min_delta": self._min_delta,
                "min_samples": self._min_samples,
                "series_watched": len(self._recent),
                "anomalies": self._anomalies,
            }


# Registry names matching any of these prefixes are sampled by default;
# everything else stays snapshot-only (bounded series, bounded cost).
DEFAULT_INCLUDE_PREFIXES = (
    "util.",
    "device.",
    "leader.",
    "helper.",
    "plain.",
    "hh.",
    "admission.",
)

# Histogram series sampled as percentiles.
_HIST_PERCENTILES = (("p50", 50.0), ("p99", 99.0))


class MetricsSampler:
    """Jittered background sampler: registry + utilization -> store.

    `registry` is duck-typed (`export() -> dict`), `utilization` is a
    `UtilizationTracker` (or anything with `export()`), both optional.
    `include` filters registry names by prefix (None = the default
    prefix set; empty tuple = registry off). `clock` and `sample_once`
    make the whole pipeline deterministic; `start()` adds the thread.

    `extra_sources` is a sequence of zero-arg callables returning
    `{series_name: value}` — sampled verbatim every tick, bypassing the
    `include` prefix filter (they are explicit by construction). The
    fleet telemetry plane rides one sampler this way: its derived
    gauges (`fleet.qps`, per-replica lag) become TSDB series without
    the sampler knowing anything about fleets.
    """

    def __init__(
        self,
        store: Optional[TimeSeriesStore] = None,
        registry=None,
        utilization=None,
        period_s: float = 1.0,
        jitter_frac: float = 0.2,
        include: Optional[Sequence[str]] = None,
        watch: Optional[AnomalyWatch] = None,
        journal=None,
        clock=time.monotonic,
        seed: int = 0,
        extra_sources: Optional[Sequence] = None,
    ):
        self.store = store if store is not None else TimeSeriesStore(
            clock=clock
        )
        self._registry = registry
        self._utilization = utilization
        self._period_s = max(0.05, float(period_s))
        self._jitter_frac = max(0.0, min(0.9, float(jitter_frac)))
        self._include = (
            tuple(include) if include is not None
            else DEFAULT_INCLUDE_PREFIXES
        )
        self.watch = watch if watch is not None else AnomalyWatch(
            journal=journal
        )
        self._extra_sources = list(extra_sources or [])
        self._clock = clock
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._samples_taken = 0
        self._errors = 0

    # -- deterministic core --------------------------------------------------

    def _selected(self, name: str) -> bool:
        return any(name.startswith(p) for p in self._include)

    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample of everything selected; returns the number
        of series written. Never raises (sampling must not hurt
        serving)."""
        if now is None:
            now = self._clock()
        written = 0
        try:
            written += self._sample_registry(now)
            written += self._sample_utilization(now)
            written += self._sample_extra(now)
            with self._lock:
                self._samples_taken += 1
        except Exception:  # noqa: BLE001 - sampling never raises
            with self._lock:
                self._errors += 1
        return written

    def _put(self, name: str, value, now: float) -> int:
        if value is None:
            return 0
        self.store.record(name, float(value), t=now)
        self.watch.observe(name, float(value), now)
        return 1

    def _sample_registry(self, now: float) -> int:
        if self._registry is None or not self._include:
            return 0
        export = self._registry.export()
        written = 0
        for name, value in export.get("counters", {}).items():
            if self._selected(name):
                written += self._put(f"{name}.count", value, now)
        for name, value in export.get("gauges", {}).items():
            if self._selected(name):
                written += self._put(name, value, now)
        for name, hist in export.get("histograms", {}).items():
            if self._selected(name):
                for suffix, _p in _HIST_PERCENTILES:
                    written += self._put(
                        f"{name}.{suffix}", hist.get(suffix), now
                    )
        return written

    def add_extra_source(self, source) -> None:
        """Register one more `() -> {series_name: value}` callable."""
        with self._lock:
            self._extra_sources.append(source)

    def _sample_extra(self, now: float) -> int:
        with self._lock:
            sources = list(self._extra_sources)
        written = 0
        for source in sources:
            try:
                values = source() or {}
            except Exception:  # noqa: BLE001 - sampling never raises
                with self._lock:
                    self._errors += 1
                continue
            for name, value in values.items():
                written += self._put(name, value, now)
        return written

    def _sample_utilization(self, now: float) -> int:
        if self._utilization is None:
            return 0
        snap = self._utilization.export()
        written = 0
        totals = snap.get("totals", {})
        windows = snap.get("windows", [])
        if windows:
            last = windows[-1]
            written += self._put(
                "util.duty_cycle_pct", last.get("duty_cycle_pct"), now
            )
            written += self._put(
                "util.device_feed_efficiency",
                last.get("device_feed_efficiency"),
                now,
            )
        written += self._put(
            "util.busy_s_total", totals.get("busy_s"), now
        )
        written += self._put(
            "util.idle_s_total", totals.get("idle_total_s"), now
        )
        for cause, seconds in totals.get("idle_s", {}).items():
            written += self._put(f"util.idle_s.{cause}", seconds, now)
        return written

    # -- thread --------------------------------------------------------------

    def _jittered_period(self) -> float:
        if self._jitter_frac == 0.0:
            return self._period_s
        spread = self._period_s * self._jitter_frac
        return self._period_s + self._rng.uniform(-spread, spread)

    def _loop(self) -> None:
        while not self._stop.wait(self._jittered_period()):
            self.sample_once()

    def start(self) -> "MetricsSampler":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="metrics-sampler"
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=timeout)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def export(self) -> dict:
        with self._lock:
            samples, errors = self._samples_taken, self._errors
        return {
            "period_s": self._period_s,
            "jitter_frac": self._jitter_frac,
            "running": self.running,
            "samples_taken": samples,
            "errors": errors,
            "include_prefixes": list(self._include),
            "watch": self.watch.export(),
            "store": {
                "series_count": self.store.export()["series_count"],
                "occupancy": self.store.occupancy(),
                "slot_budget": self.store.slot_budget(),
                "approx_bytes": self.store.approx_bytes(),
            },
        }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -- text rendering ----------------------------------------------------------


def sparkline(values: Sequence[float], width: int = 60) -> str:
    """Block-glyph sparkline of the last `width` values (empty input ->
    empty string); constant series render flat mid-height."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_GLYPHS[3] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK_GLYPHS[
            min(
                len(_SPARK_GLYPHS) - 1,
                int((v - lo) / span * len(_SPARK_GLYPHS)),
            )
        ]
        for v in vals
    )


def render_sparklines(
    store: TimeSeriesStore,
    names: Optional[Sequence[str]] = None,
    tier: int = 0,
    width: int = 60,
) -> str:
    """One line per series: latest value, min..max, sparkline."""
    lines = []
    for name in names if names is not None else store.names():
        points = store.series(name, tier=tier)
        if not points:
            continue
        values = [v for _, v in points]
        lines.append(
            f"{name:<44} {values[-1]:>12.4g}  "
            f"[{min(values):.4g}..{max(values):.4g}]  "
            f"{sparkline(values, width=width)}"
        )
    return "\n".join(lines)
