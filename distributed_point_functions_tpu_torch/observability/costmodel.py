"""Cost-model accuracy ledger: predicted-vs-actual capacity validation,
copied from the JAX package's `observability/costmodel.py`.

The `CapacityModel` (`capacity/model.py`) prices work in peak device
bytes and estimated device-ms. The `CostLedger` joins each estimate with
the measured truth, per (workload, planner-tier, shape-bucket) residual
reservoirs: in the port, every folded level of
`heavy_hitters/aggregator.py` (its level's wall ms, synchronized, and
how far the level raised the allocator's peak).

The *residual* is the signed ratio error::

    residual = actual_device_ms / predicted_device_ms - 1.0

so 0.0 is a perfect price, +1.0 means the device took twice as long as
the model said (over-admission risk), and -0.5 means the model charged
double (over-shedding risk). Each cell keeps a bounded reservoir
(p50/p95/p99 on demand), sample counts, and the worst |residual| seen
with its trace id, and mirrors every observation into a
``capacity_residual_ratio{workload=,tier=,bucket=}`` histogram family
on the bound registry — the Prometheus exposition renders trace-id
exemplars on the worst buckets for free.

**Drift detection.** Every `window_size` samples a cell closes a
window and checks the window's |p50 residual| against the configured
band. `drift_windows` consecutive out-of-band windows flip the cell
into *drifting*: a ``capacity.drift`` journal event fires, the
``capacity.drift_cells`` registry gauge rises, and the
`drift_objective()` SLO (a ``gauge_max`` over that gauge) degrades
`/healthz` (where a process serves one) the way a breaker trip does.
One in-band window clears the cell and the gauge falls back.

Closed windows also fan out to registered window listeners, so a
recalibrator (the JAX package's `capacity/recalibrate.py`, not ported)
can subscribe without this module importing the capacity layer (the
ledger accepts plain floats).

Settings are constructor arguments (no environment variable is read):
`window_size` samples per drift window (32), `drift_band` the |p50|
band in ratio units (0.35), `drift_windows` consecutive windows to trip
(3).

Layering: imports only stdlib and observability siblings (`events`,
`tracing`, `slo`) — usable from capacity, pir, serving, and
heavy_hitters without an upward edge.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

from . import events as events_mod
from . import tracing
from .slo import SloObjective

__all__ = [
    "DRIFT_GAUGE",
    "RESIDUAL_BUCKETS",
    "shape_bucket",
    "CostLedger",
    "drift_objective",
    "default_cost_ledger",
    "set_default_cost_ledger",
]

# Residual reservoir per cell: enough for stable p99 over a long-lived
# serving process without unbounded growth.
_RESERVOIR = 1024

# The registry gauge the drift detector maintains (count of cells
# currently drifting) and the histogram family every observation
# mirrors into.
DRIFT_GAUGE = "capacity.drift_cells"
_RESIDUAL_HIST = "capacity_residual_ratio"

# Ratio-error bucket bounds for the residual histogram family: the
# default registry buckets are latency-shaped (milliseconds), useless
# for a signed ratio centered on zero.
RESIDUAL_BUCKETS = (
    -0.75, -0.5, -0.25, -0.1, -0.05, -0.02, 0.0,
    0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0,
)

def shape_bucket(quantity: int) -> str:
    """Power-of-two shape-bucket label for a work quantity (keys,
    lanes) — the rounding of the batcher's key buckets, so one cell
    maps to one shape family."""
    q = int(quantity)
    if q <= 0:
        return "0"
    return str(1 << max(0, (q - 1).bit_length()))


def _percentile(ordered: List[float], p: float) -> Optional[float]:
    if not ordered:
        return None
    i = min(len(ordered) - 1, max(0, round(p / 100 * (len(ordered) - 1))))
    return ordered[i]


@contextlib.contextmanager
def _with_trace(trace):
    """Make `trace` current for the enclosed block so histogram
    exemplars attach to the request that produced the residual (the
    batcher worker observes on its own thread, outside any trace)."""
    if trace is None:
        yield
        return
    token = tracing._CURRENT.set(trace)
    try:
        yield
    finally:
        tracing._CURRENT.reset(token)


class _Cell:
    """One (workload, tier, bucket) residual reservoir."""

    __slots__ = (
        "residuals", "bytes_residuals", "samples", "unpriced",
        "predicted_ms_sum", "actual_ms_sum", "transfer_bytes_sum",
        "worst", "window", "windows_closed", "consecutive_out",
        "drifting", "last_window_p50",
    )

    def __init__(self):
        self.residuals = collections.deque(maxlen=_RESERVOIR)
        self.bytes_residuals = collections.deque(maxlen=_RESERVOIR)
        self.samples = 0
        self.unpriced = 0
        self.predicted_ms_sum = 0.0
        self.actual_ms_sum = 0.0
        self.transfer_bytes_sum = 0
        self.worst: Optional[Tuple[float, Optional[str]]] = None
        self.window: List[float] = []
        self.windows_closed = 0
        self.consecutive_out = 0
        self.drifting = False
        self.last_window_p50: Optional[float] = None

    def export(self) -> dict:
        ordered = sorted(self.residuals)
        out = {
            "samples": self.samples,
            "unpriced": self.unpriced,
            "residual_p50": _round(_percentile(ordered, 50)),
            "residual_p95": _round(_percentile(ordered, 95)),
            "residual_p99": _round(_percentile(ordered, 99)),
            "mean_predicted_ms": _round(
                self.predicted_ms_sum / self.samples if self.samples else None
            ),
            "mean_actual_ms": _round(
                self.actual_ms_sum / self.samples if self.samples else None
            ),
            "transfer_bytes": self.transfer_bytes_sum,
            "windows_closed": self.windows_closed,
            "consecutive_out": self.consecutive_out,
            "drifting": self.drifting,
            "last_window_p50": _round(self.last_window_p50),
        }
        if self.worst is not None:
            out["worst"] = {
                "residual": _round(self.worst[0]),
                "trace_id": self.worst[1],
            }
        if self.bytes_residuals:
            ob = sorted(self.bytes_residuals)
            out["bytes_residual_p50"] = _round(_percentile(ob, 50))
            out["bytes_samples"] = len(self.bytes_residuals)
        return out


def _round(v: Optional[float], nd: int = 4) -> Optional[float]:
    return None if v is None else round(v, nd)


class CostLedger:
    """Joins capacity-model estimates with measured device truth into
    per-(workload, tier, shape-bucket) residual cells.

    One instance per process is the normal deployment
    (`default_cost_ledger()`); tests construct their own with small
    windows so drift trips deterministically.
    """

    def __init__(
        self,
        window_size: int = 32,
        drift_band: float = 0.35,
        drift_windows: int = 3,
    ):
        self.window_size = max(1, int(window_size))
        self.drift_band = float(drift_band)
        self.drift_windows = max(1, int(drift_windows))
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, str, str], _Cell] = {}
        self._registry = None
        self._window_listeners: List[Callable] = []

    # -- wiring -------------------------------------------------------------

    def bind_registry(self, registry) -> "CostLedger":
        """Mirror residuals into `registry` histograms and maintain the
        drift gauge there (created at 0 so the SLO objective grades
        `ok` rather than `no_data` before the first window)."""
        with self._lock:
            self._registry = registry
        if registry is not None:
            registry.gauge(DRIFT_GAUGE).set(0.0)
        return self

    def add_window_listener(self, listener: Callable) -> None:
        """Register `listener(workload, tier, bucket, window)` to fire
        each time a cell closes a drift window; `window` carries
        ``p50``, ``samples`` (window size), ``cell_samples`` (lifetime
        count), and ``drifting``. Called outside the ledger lock;
        exceptions are swallowed — accounting must never take serving
        down."""
        with self._lock:
            self._window_listeners.append(listener)

    # -- the join -----------------------------------------------------------

    def observe(
        self,
        workload: str,
        tier: str,
        bucket: str,
        predicted_device_ms: float,
        actual_device_ms: float,
        predicted_bytes: int = 0,
        actual_bytes: int = 0,
        transfer_bytes: int = 0,
        trace=None,
        trace_id: Optional[str] = None,
    ) -> Optional[float]:
        """Join one estimate with one measurement; returns the residual
        (or None when the sample was unpriceable). Never raises."""
        try:
            return self._observe(
                workload, tier, bucket, predicted_device_ms,
                actual_device_ms, predicted_bytes, actual_bytes,
                transfer_bytes, trace, trace_id,
            )
        except Exception:  # noqa: BLE001 - accounting must never break serving
            return None

    def _observe(
        self, workload, tier, bucket, predicted_ms, actual_ms,
        predicted_bytes, actual_bytes, transfer_bytes, trace, trace_id,
    ) -> Optional[float]:
        key = (str(workload), str(tier), str(bucket))
        closed_window = None
        drift_event = None
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _Cell()
            if not (predicted_ms and predicted_ms > 0 and actual_ms >= 0):
                cell.unpriced += 1
                return None
            residual = actual_ms / predicted_ms - 1.0
            cell.residuals.append(residual)
            cell.samples += 1
            cell.predicted_ms_sum += predicted_ms
            cell.actual_ms_sum += actual_ms
            cell.transfer_bytes_sum += max(0, int(transfer_bytes))
            if trace_id is None and trace is not None:
                trace_id = getattr(trace, "trace_id", None)
            if cell.worst is None or abs(residual) > abs(cell.worst[0]):
                cell.worst = (residual, trace_id)
            if predicted_bytes and predicted_bytes > 0 and actual_bytes > 0:
                cell.bytes_residuals.append(
                    actual_bytes / predicted_bytes - 1.0
                )
            cell.window.append(residual)
            if len(cell.window) >= self.window_size:
                closed_window, drift_event = self._close_window(key, cell)
            registry = self._registry
            drifting_cells = sum(
                1 for c in self._cells.values() if c.drifting
            )
        # Registry, journal, and listeners all run outside the lock.
        if registry is not None:
            with _with_trace(trace):
                registry.histogram(
                    _RESIDUAL_HIST,
                    buckets=RESIDUAL_BUCKETS,
                    labels={
                        "workload": key[0], "tier": key[1],
                        "bucket": key[2],
                    },
                ).observe(residual)
            registry.gauge(DRIFT_GAUGE).set(float(drifting_cells))
        if drift_event is not None:
            state, p50 = drift_event
            events_mod.emit(
                "capacity.drift",
                message=(
                    f"cost model {state} for {key[0]}/{key[1]}/{key[2]}: "
                    f"window p50 residual {p50:+.3f} "
                    f"(band +/-{self.drift_band})"
                ),
                severity="warning" if state == "drifting" else "info",
                workload=key[0], tier=key[1], bucket=key[2],
                state=state, window_p50=round(p50, 4),
            )
        if closed_window is not None:
            with self._lock:
                listeners = list(self._window_listeners)
            for listener in listeners:
                try:
                    listener(key[0], key[1], key[2], closed_window)
                except Exception:  # noqa: BLE001 - see add_window_listener
                    pass
        return residual

    def _close_window(self, key, cell):
        """Fold the cell's open window (caller holds the lock); returns
        (window dict, drift transition or None)."""
        ordered = sorted(cell.window)
        p50 = _percentile(ordered, 50)
        cell.window = []
        cell.windows_closed += 1
        cell.last_window_p50 = p50
        out_of_band = abs(p50) > self.drift_band
        drift_event = None
        if out_of_band:
            cell.consecutive_out += 1
            if (
                cell.consecutive_out >= self.drift_windows
                and not cell.drifting
            ):
                cell.drifting = True
                drift_event = ("drifting", p50)
        else:
            cell.consecutive_out = 0
            if cell.drifting:
                cell.drifting = False
                drift_event = ("cleared", p50)
        window = {
            "p50": p50,
            "samples": len(ordered),
            "cell_samples": cell.samples,
            "drifting": cell.drifting,
        }
        return window, drift_event

    # -- reading ------------------------------------------------------------

    def drifting_cells(self) -> List[str]:
        with self._lock:
            return [
                "/".join(k)
                for k, c in sorted(self._cells.items())
                if c.drifting
            ]

    def export(self) -> dict:
        """The /capacityz view: one entry per cell plus the drift
        configuration and totals."""
        with self._lock:
            cells = {
                "/".join(k): c.export()
                for k, c in sorted(self._cells.items())
            }
            drifting = [k for k, c in sorted(self._cells.items())
                        if c.drifting]
        return {
            "window_size": self.window_size,
            "drift_band": self.drift_band,
            "drift_windows": self.drift_windows,
            "cells": cells,
            "drifting": ["/".join(k) for k in drifting],
            "total_samples": sum(c["samples"] for c in cells.values()),
            "total_unpriced": sum(c["unpriced"] for c in cells.values()),
        }

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            registry = self._registry
        if registry is not None:
            registry.gauge(DRIFT_GAUGE).set(0.0)


def drift_objective(
    name: str = "capacity-cost-drift",
    threshold: float = 0.0,
    severity: str = "hard",
) -> SloObjective:
    """The SLO objective that makes cost-model drift degrade `/healthz`
    like a breaker trip: breach while any cell is drifting (the
    `capacity.drift_cells` gauge above `threshold`)."""
    return SloObjective(
        name=name,
        kind="gauge_max",
        metric=DRIFT_GAUGE,
        threshold=threshold,
        severity=severity,
    )


_default_ledger: Optional[CostLedger] = None
_default_lock = threading.Lock()


def default_cost_ledger() -> CostLedger:
    """The process-wide ledger the batcher and aggregator write to."""
    global _default_ledger
    with _default_lock:
        if _default_ledger is None:
            _default_ledger = CostLedger()
        return _default_ledger


def set_default_cost_ledger(
    ledger: Optional[CostLedger],
) -> Optional[CostLedger]:
    """Swap the process-wide ledger (tests; None restores the lazy
    default). Returns the previous ledger."""
    global _default_ledger
    with _default_lock:
        previous = _default_ledger
        _default_ledger = ledger
        return previous
