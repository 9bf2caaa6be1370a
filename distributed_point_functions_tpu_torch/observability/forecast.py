"""Forecast plane: act-before-burn signals from the flight recorder.
Copied from the JAX package's `observability/forecast.py` (stdlib,
`events` and `slo` only).

The `TimeSeriesStore` keeps the recent past; every SLO before this
module grades the *present*. This module closes the gap with a
dependency-free double-exponential (Holt) forecaster over selected
TSDB series — arrival rate, duty cycle, admission queue depth,
`capacity.drift_cells` — producing horizon forecasts with confidence
bands and, the headline number, **predicted time-to-breach** against
declared ceilings (calibrated `CapacityModel` capacity, SLO ceilings).

The loop it enables:

* `/forecastz` shows the per-series forecast and the fleet's earliest
  predicted breach; `/statusz` folds the summary in.
* A predicted breach inside `page_horizon_s` journals ONE coalesced
  `forecast.breach_predicted` event (warning severity — it pages, it
  does not drain).
* `objective()` wires the same signal as a *soft* SLO: the tracker
  grades the `<name>.min_time_to_breach_s` gauge with `gauge_min`, so
  a predicted breach shows up on the standard burn surfaces without
  ever degrading `/healthz`.
* `capacity.admission.PredictiveGovernor` reads
  `min_time_to_breach_s()` and tightens tenant token buckets as the
  forecast approaches capacity; `serving.snapshots.RotationCoordinator
  .suggest_window()` reads `trough_window()` to prestage into forecast
  troughs.

Ceilings arrive as plain floats or zero-arg callables
(`ceiling_source=default_capacity_model().serving_queries_per_sec`) —
duck-typed so this package never imports capacity/ (layering:
observability sits below it).

Forecast math (deliberately boring): Holt's linear method with
smoothing `alpha` on the level and `beta` on the trend, fit by one
pass over the aligned window (gaps skipped); the confidence band is
the one-step residual std scaled by sqrt(steps-ahead). Time-to-breach
solves `level + trend * k >= ceiling` for the first step `k`, reported
both as the expected crossing and the *earliest plausible* crossing
(the lower band edge crossing first) — act-before-burn wants the
pessimistic edge.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from . import events as events_mod
from .slo import SloObjective

__all__ = [
    "Forecaster",
    "SeriesForecast",
    "holt_fit",
]

_Z95 = 1.96


def holt_fit(
    values: Sequence[float],
    alpha: float = 0.5,
    beta: float = 0.3,
) -> Optional[dict]:
    """One-pass Holt (double-exponential) fit.

    Returns `{"level", "trend", "residual_std", "n"}` — the smoothed
    level/trend after the last sample and the std of the one-step-ahead
    residuals (the band width unit). None with fewer than 3 samples."""
    xs = [float(v) for v in values]
    if len(xs) < 3:
        return None
    level = xs[0]
    trend = xs[1] - xs[0]
    residuals = []
    for x in xs[1:]:
        predicted = level + trend
        residuals.append(x - predicted)
        new_level = alpha * x + (1 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1 - beta) * trend
        level = new_level
    n = len(residuals)
    mean_r = sum(residuals) / n
    var = sum((r - mean_r) ** 2 for r in residuals) / max(1, n - 1)
    return {
        "level": level,
        "trend": trend,
        "residual_std": math.sqrt(max(0.0, var)),
        "n": len(xs),
    }


class SeriesForecast:
    """One watched series: where to read it and what ceiling it must
    stay on the right side of."""

    def __init__(
        self,
        series: str,
        *,
        ceiling: Optional[float] = None,
        ceiling_source: Optional[Callable[[], float]] = None,
        direction: str = "above",
        label: Optional[str] = None,
        tier: Optional[int] = None,
    ):
        if direction not in ("above", "below"):
            raise ValueError("direction must be 'above' or 'below'")
        if ceiling is None and ceiling_source is None:
            raise ValueError("need ceiling or ceiling_source")
        self.series = series
        self._ceiling = ceiling
        self._ceiling_source = ceiling_source
        self.direction = direction
        self.label = label if label is not None else series
        self.tier = tier

    def ceiling_value(self) -> Optional[float]:
        if self._ceiling_source is not None:
            try:
                return float(self._ceiling_source())
            except Exception:  # noqa: BLE001 - a broken source is no data
                return None
        return self._ceiling


class Forecaster:
    """Holt forecasts + predicted time-to-breach over a
    `TimeSeriesStore` (see module docstring).

    `run()` is the deterministic core (tests and the CI smoke drive it
    with explicit `now`); `export()` re-runs and returns the
    `/forecastz` state. The min time-to-breach across every watched
    series lands in the `<name>.min_time_to_breach_s` gauge when a
    registry is bound — clamped to `horizon_s` when nothing is
    predicted to breach, so the soft `gauge_min` objective always has
    finite data to grade."""

    def __init__(
        self,
        store,
        *,
        window_s: float = 120.0,
        horizon_s: float = 300.0,
        alpha: float = 0.5,
        beta: float = 0.3,
        min_points: int = 8,
        page_horizon_s: float = 120.0,
        coalesce_s: float = 30.0,
        registry=None,
        journal=None,
        name: str = "forecast",
        clock=time.monotonic,
    ):
        self._store = store
        self.window_s = float(window_s)
        self.horizon_s = float(horizon_s)
        self._alpha = float(alpha)
        self._beta = float(beta)
        self._min_points = int(min_points)
        self.page_horizon_s = float(page_horizon_s)
        self._coalesce_s = float(coalesce_s)
        self._registry = registry
        self._journal = journal
        self._name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._targets: List[SeriesForecast] = []
        self._last_run: Optional[dict] = None
        self._breaches_predicted = 0

    # -- wiring --------------------------------------------------------------

    def watch(
        self,
        series: str,
        *,
        ceiling: Optional[float] = None,
        ceiling_source: Optional[Callable[[], float]] = None,
        direction: str = "above",
        label: Optional[str] = None,
        tier: Optional[int] = None,
    ) -> "Forecaster":
        """Watch `series` against a ceiling (float or zero-arg callable
        — e.g. `default_capacity_model().serving_queries_per_sec`).
        Returns self for chaining."""
        with self._lock:
            self._targets.append(
                SeriesForecast(
                    series,
                    ceiling=ceiling,
                    ceiling_source=ceiling_source,
                    direction=direction,
                    label=label,
                    tier=tier,
                )
            )
        return self

    def bind_registry(self, registry) -> None:
        self._registry = registry

    def objective(
        self,
        threshold_s: float = 60.0,
        name: str = "forecast_breach",
    ) -> SloObjective:
        """The soft SLO objective over this forecaster's gauge: pages
        when the earliest predicted breach comes closer than
        `threshold_s`, never drains (severity is forced soft — a
        prediction must not 503 a healthy process)."""
        return SloObjective(
            name=name,
            kind="gauge_min",
            metric=f"{self._name}.min_time_to_breach_s",
            threshold=float(threshold_s),
            severity="soft",
        )

    # -- the forecast --------------------------------------------------------

    def _samples(
        self, target: SeriesForecast, now: float
    ) -> Tuple[float, List[float]]:
        step_s, aligned = self._store.query_range(
            target.series, now - self.window_s, now, tier=target.tier,
            now=now,
        )
        return step_s, [v for _, v in aligned if v is not None]

    def forecast_series(
        self, target: SeriesForecast, now: float
    ) -> dict:
        """Forecast one watched series. Always returns a record; the
        `state` field says whether there was enough data to predict."""
        step_s, values = self._samples(target, now)
        ceiling = target.ceiling_value()
        record: dict = {
            "series": target.series,
            "label": target.label,
            "direction": target.direction,
            "ceiling": ceiling,
            "step_s": step_s,
            "points": len(values),
            "state": "ok",
            "time_to_breach_s": None,
            "time_to_breach_earliest_s": None,
        }
        if len(values) < self._min_points:
            record["state"] = "insufficient_data"
            return record
        fit = holt_fit(values, alpha=self._alpha, beta=self._beta)
        if fit is None:
            record["state"] = "insufficient_data"
            return record
        level, trend = fit["level"], fit["trend"]
        std = fit["residual_std"]
        record.update(
            level=round(level, 4),
            trend_per_s=round(trend / step_s, 6) if step_s else 0.0,
            residual_std=round(std, 4),
            last=round(values[-1], 4),
        )
        horizon_steps = max(1, int(self.horizon_s // step_s))
        band: List[dict] = []
        # A handful of horizon waypoints, not every step: the export
        # stays bundle-sized at any horizon.
        for k in _waypoints(horizon_steps):
            width = _Z95 * std * math.sqrt(k)
            mid = level + trend * k
            band.append({
                "t_offset_s": round(k * step_s, 3),
                "mid": round(mid, 4),
                "lo": round(mid - width, 4),
                "hi": round(mid + width, 4),
            })
        record["band"] = band
        if ceiling is None:
            record["state"] = "no_ceiling"
            return record
        sign = 1.0 if target.direction == "above" else -1.0
        # Normalize to "breach when f(k) >= ceiling'" coordinates.
        lvl = sign * level
        trd = sign * trend
        ceil = sign * ceiling
        record["time_to_breach_s"] = _crossing_s(
            lvl, trd, 0.0, ceil, step_s, horizon_steps
        )
        record["time_to_breach_earliest_s"] = _crossing_s(
            lvl, trd, _Z95 * std, ceil, step_s, horizon_steps
        )
        return record

    def run(self, now: Optional[float] = None) -> dict:
        """One full forecast pass: every watched series, the min
        time-to-breach gauge, and (when a breach is predicted inside
        `page_horizon_s`) one coalesced `forecast.breach_predicted`
        journal event per series."""
        if now is None:
            now = self._clock()
        with self._lock:
            targets = list(self._targets)
        series = [self.forecast_series(t, now) for t in targets]
        ttbs = [
            r["time_to_breach_earliest_s"]
            for r in series
            if r["time_to_breach_earliest_s"] is not None
        ]
        min_ttb = min(ttbs) if ttbs else None
        # Finite even when calm: the soft gauge_min objective needs a
        # value to grade, and "no breach inside the horizon" IS the
        # healthy reading.
        gauge_value = (
            min(min_ttb, self.horizon_s)
            if min_ttb is not None
            else self.horizon_s
        )
        if self._registry is not None:
            self._registry.gauge(
                f"{self._name}.min_time_to_breach_s"
            ).set(round(gauge_value, 3))
            self._registry.gauge(f"{self._name}.targets").set(
                float(len(series))
            )
        paged = []
        for r in series:
            ttb = r["time_to_breach_earliest_s"]
            if ttb is None or ttb > self.page_horizon_s:
                continue
            paged.append(r["series"])
            self._emit(
                "forecast.breach_predicted",
                f"{r['label']}: predicted to cross "
                f"{r['ceiling']} in {ttb:.0f}s "
                f"(level {r.get('level')}, trend/s "
                f"{r.get('trend_per_s')})",
                severity="warning",
                coalesce_key=f"forecast.breach:{r['series']}",
                coalesce_s=self._coalesce_s,
                series=r["series"],
                time_to_breach_s=ttb,
                ceiling=r["ceiling"],
                direction=r["direction"],
            )
        state = {
            "name": self._name,
            "now": round(now, 3),
            "window_s": self.window_s,
            "horizon_s": self.horizon_s,
            "page_horizon_s": self.page_horizon_s,
            "alpha": self._alpha,
            "beta": self._beta,
            "series": series,
            "min_time_to_breach_s": (
                round(min_ttb, 3) if min_ttb is not None else None
            ),
            "gauge_value_s": round(gauge_value, 3),
            "paging": paged,
        }
        with self._lock:
            self._last_run = state
            self._breaches_predicted += len(paged)
        return state

    def min_time_to_breach_s(
        self, now: Optional[float] = None
    ) -> Optional[float]:
        """The earliest predicted breach across every watched series
        (None = nothing predicted inside the horizon). The
        `PredictiveGovernor`'s forecast source."""
        return self.run(now=now)["min_time_to_breach_s"]

    def export(self, now: Optional[float] = None) -> dict:
        state = self.run(now=now)
        with self._lock:
            state["breaches_predicted_total"] = self._breaches_predicted
        return state

    def last_run(self) -> Optional[dict]:
        """The most recent `run()` state without re-running (the
        /statusz fold-in uses this to stay cheap)."""
        with self._lock:
            return self._last_run

    # -- troughs (rotation prestage) -----------------------------------------

    def trough_window(
        self,
        series: str,
        window_s: float = 30.0,
        now: Optional[float] = None,
        tier: Optional[int] = None,
    ) -> dict:
        """The lowest-forecast window of `window_s` seconds inside the
        horizon for `series` — where a rotation prestage (bytes on the
        interconnect) steals the least serving headroom. Falls back to
        "now" when the series has too little history to forecast."""
        if now is None:
            now = self._clock()
        target = SeriesForecast(
            series, ceiling=float("inf"), tier=tier
        )
        step_s, values = self._samples(target, now)
        out = {
            "series": series,
            "window_s": float(window_s),
            "start_offset_s": 0.0,
            "expected_value": None,
            "state": "insufficient_data",
        }
        if len(values) < self._min_points:
            return out
        fit = holt_fit(values, alpha=self._alpha, beta=self._beta)
        if fit is None:
            return out
        level, trend = fit["level"], fit["trend"]
        horizon_steps = max(1, int(self.horizon_s // step_s))
        window_steps = max(1, int(round(window_s / step_s)))
        best_start, best_mean = 0, None
        for start in range(0, max(1, horizon_steps - window_steps + 1)):
            mid = start + (window_steps - 1) / 2.0
            mean = level + trend * mid
            if best_mean is None or mean < best_mean:
                best_start, best_mean = start, mean
        out.update(
            state="ok",
            start_offset_s=round(best_start * step_s, 3),
            expected_value=round(max(0.0, best_mean), 4),
            trend_per_s=round(trend / step_s, 6) if step_s else 0.0,
        )
        return out

    def window_source(
        self, series: str
    ) -> Callable[[float], dict]:
        """A `window_s -> suggestion` binding for
        `RotationCoordinator.set_window_source` (duck-typed: serving
        never imports this module's types)."""
        return lambda window_s: self.trough_window(series, window_s)

    # -- internals -----------------------------------------------------------

    def _emit(self, kind, message, severity="warning", **fields):
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        try:
            journal.emit(kind, message, severity=severity, **fields)
        except Exception:  # noqa: BLE001 - telemetry never raises
            pass


def _waypoints(horizon_steps: int, count: int = 8) -> List[int]:
    """Up to `count` strictly increasing step offsets covering
    [1, horizon_steps]."""
    if horizon_steps <= count:
        return list(range(1, horizon_steps + 1))
    out = []
    for i in range(1, count + 1):
        k = max(1, round(i * horizon_steps / count))
        if not out or k > out[-1]:
            out.append(k)
    return out


def _crossing_s(
    level: float,
    trend: float,
    band_head_start: float,
    ceiling: float,
    step_s: float,
    horizon_steps: int,
) -> Optional[float]:
    """Seconds until `level + trend*k + band_head_start*sqrt(k)`
    first reaches `ceiling`, scanning whole steps inside the horizon
    (None = no crossing predicted). `band_head_start`>0 gives the
    earliest-plausible crossing (upper band edge)."""
    if level >= ceiling:
        return 0.0
    for k in range(1, horizon_steps + 1):
        predicted = level + trend * k + band_head_start * math.sqrt(k)
        if predicted >= ceiling:
            return round(k * step_s, 3)
    return None
