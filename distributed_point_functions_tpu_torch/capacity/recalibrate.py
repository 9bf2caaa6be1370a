"""Guarded online recalibration of the capacity model's prices, the
JAX package's `capacity/recalibrate.py` with its switches as code: the
kill switch is `Recalibrator.set_enabled`, the sample floor the
`min_samples` argument (the JAX package reads both from the
environment).

The cost ledger (`observability/costmodel.py`) measures how wrong each
admission price was; this module closes the loop — carefully. A
`Recalibrator` subscribes to the ledger's closed drift windows and
maintains one EWMA correction factor per *workload* (the ledger's
tiers and shape buckets fold together: admission prices a request
before the planner has picked either, so a finer key would never be
consulted), which it serves to `CapacityModel` through the model's
correction-provider hook, so `price_pir_keys` / `price_hh_level` — and
therefore admission's queue-drain estimate and the brownout ladder's
shed decisions — use corrected device-ms from the next priced request
onward. Because the ledger observes *corrected* prices, the loop is
self-stabilizing: once the corrected prediction matches the measured
truth the window p50 residual goes to zero and the factor stops
moving.

Guardrails, in order of application:

* **min samples** — a cell contributes nothing until it has seen
  `min_samples` lifetime observations; cold cells never steer prices.
* **clamp** — the factor is clamped to `clamp = (lo, hi)` (default
  0.5x..2.0x); a pathological measurement cannot run the price to zero
  or infinity.
* **bounded step** — each window moves the factor multiplicatively by
  at most `1 + alpha * |p50|`, so one bad window nudges, not slams.
* **kill switch** — `set_enabled(False)` (read on every price) reverts
  to raw prices at once without restarting anything; the revert is
  journaled once (`capacity.correction_reverted`) and `set_enabled(True)`
  resumes from the learned factors.

Every materially changed factor is journaled as
`capacity.correction_applied` (coalesced per cell), so `/eventz` and
the brownout ladder's operators can see exactly when and why prices
moved.

`CapacityAccuracy` is the read-side glue: one `export()` bundling the
ledger, the recalibrator, and the model (with calibration staleness)
for `/capacityz`, the `/statusz` section, and debug bundles.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..observability import costmodel as costmodel_mod
from ..observability import events as events_mod
from . import model as model_mod

__all__ = [
    "Recalibrator",
    "CapacityAccuracy",
    "default_recalibrator",
    "set_default_recalibrator",
]

# Journal a correction_applied only when the factor moved at least
# this much since the last journaled value for the cell — windows close
# constantly; the journal should see direction changes, not jitter.
_JOURNAL_DELTA = 0.02


class Recalibrator:
    """Clamped per-cell EWMA correction factors learned from ledger
    drift windows and served to `CapacityModel.price_*`."""

    def __init__(
        self,
        model: Optional[model_mod.CapacityModel] = None,
        ledger: Optional[costmodel_mod.CostLedger] = None,
        alpha: float = 0.5,
        clamp: Tuple[float, float] = (0.5, 2.0),
        min_samples: int = 32,
    ):
        self.alpha = alpha
        self.clamp = (float(clamp[0]), float(clamp[1]))
        self.min_samples = max(1, int(min_samples))
        self._enabled = True
        self._lock = threading.Lock()
        # workload -> factor (see module docstring for why the key is
        # coarser than the ledger's cells).
        self._factors: Dict[str, float] = {}
        self._journaled: Dict[str, float] = {}
        self._applied_events = 0
        self._reverted = False
        self._model = model
        self._ledger = ledger
        self._installed = False

    # -- wiring -------------------------------------------------------------

    def install(self) -> "Recalibrator":
        """Subscribe to the ledger's drift windows and become the
        model's correction provider. Idempotent."""
        if self._installed:
            return self
        self._installed = True
        model = self._model or model_mod.default_capacity_model()
        ledger = self._ledger or costmodel_mod.default_cost_ledger()
        self._model, self._ledger = model, ledger
        ledger.add_window_listener(self._on_window)
        model.set_correction_provider(self.correction)
        return self

    def uninstall(self) -> None:
        """Detach from the model (the ledger listener stays registered
        but becomes inert through the provider)."""
        if self._model is not None:
            self._model.set_correction_provider(None)
        self._installed = False

    # -- the learning step --------------------------------------------------

    def _on_window(self, workload, tier, bucket, window) -> None:
        """One closed ledger window: move the cell's factor toward the
        corrected-price-matches-truth fixed point."""
        if window.get("cell_samples", 0) < self.min_samples:
            return
        p50 = window.get("p50")
        if p50 is None:
            return
        lo, hi = self.clamp
        with self._lock:
            factor = self._factors.get(workload, 1.0)
            # The window measured actual/corrected_predicted - 1; a
            # multiplicative EWMA step toward (1 + p50) converges the
            # corrected price onto the measurement.
            step = 1.0 + self.alpha * p50
            new_factor = min(hi, max(lo, factor * step))
            self._factors[workload] = new_factor
            last = self._journaled.get(workload, 1.0)
            journal = abs(new_factor - last) >= _JOURNAL_DELTA
            if journal:
                self._journaled[workload] = new_factor
                self._applied_events += 1
        if journal:
            events_mod.emit(
                "capacity.correction_applied",
                message=(
                    f"price correction for {workload}: x{new_factor:.3f} "
                    f"(from {workload}/{tier}/{bucket} window p50 residual "
                    f"{p50:+.3f}, clamp [{lo}, {hi}])"
                ),
                severity="info",
                coalesce_key=f"corr:{workload}",
                coalesce_s=5.0,
                workload=workload,
                tier=tier,
                bucket=bucket,
                factor=round(new_factor, 4),
                window_p50=round(p50, 4),
            )

    # -- the kill switch ----------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        """The kill switch: False prices raw from the next price on (the
        revert is journaled once); True resumes from the learned factors."""
        self._enabled = bool(enabled)

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- the serving step ---------------------------------------------------

    def correction(self, workload: str, quantity: int) -> float:
        """The factor `CapacityModel._corrected` multiplies in. Reads the
        kill switch on every call, so `set_enabled(False)` reverts every
        later price without a restart."""
        if not self._enabled:
            self._note_reverted()
            return 1.0
        self._note_reenabled()
        with self._lock:
            return self._factors.get(workload, 1.0)

    def _note_reverted(self) -> None:
        with self._lock:
            if self._reverted or not self._factors:
                return
            self._reverted = True
            factors = {
                k: round(v, 4) for k, v in sorted(self._factors.items())
            }
        events_mod.emit(
            "capacity.correction_reverted",
            message=(
                "recalibration kill switch engaged; "
                f"{len(factors)} learned factor(s) bypassed, pricing raw"
            ),
            severity="warning",
            factors=factors,
        )

    def _note_reenabled(self) -> None:
        with self._lock:
            self._reverted = False

    # -- reading ------------------------------------------------------------

    def factor(self, workload: str) -> float:
        with self._lock:
            return self._factors.get(workload, 1.0)

    def reset(self) -> None:
        with self._lock:
            self._factors.clear()
            self._journaled.clear()
            self._reverted = False

    def export(self) -> dict:
        with self._lock:
            factors = {
                k: round(v, 4) for k, v in sorted(self._factors.items())
            }
            applied = self._applied_events
            reverted = self._reverted
        return {
            "enabled": self._enabled,
            "alpha": self.alpha,
            "clamp": list(self.clamp),
            "min_samples": self.min_samples,
            "factors": factors,
            "applied_events": applied,
            "reverted": reverted,
        }


class CapacityAccuracy:
    """The `/capacityz` read model: ledger residuals + recalibration
    state + the capacity model (with calibration staleness) behind one
    duck-typed `export()` the admin server can hold without importing
    the capacity layer."""

    def __init__(
        self,
        ledger: Optional[costmodel_mod.CostLedger] = None,
        recalibrator: Optional[Recalibrator] = None,
        model: Optional[model_mod.CapacityModel] = None,
    ):
        self.ledger = ledger or costmodel_mod.default_cost_ledger()
        self.model = model or model_mod.default_capacity_model()
        self.recalibrator = recalibrator

    def export(self) -> dict:
        out = {
            "ledger": self.ledger.export(),
            "model": self.model.export(),
        }
        if self.recalibrator is not None:
            out["recalibration"] = self.recalibrator.export()
        return out


_default_recalibrator: Optional[Recalibrator] = None
_default_rec_lock = threading.Lock()


def default_recalibrator() -> Recalibrator:
    """The process-wide recalibrator serving sessions share — created
    installed (listening on the default ledger, correcting the default
    model) on first use, so every session wires the same loop instead
    of stacking listeners."""
    global _default_recalibrator
    with _default_rec_lock:
        if _default_recalibrator is None:
            _default_recalibrator = Recalibrator().install()
        return _default_recalibrator


def set_default_recalibrator(
    recalibrator: Optional[Recalibrator],
) -> Optional[Recalibrator]:
    """Swap the process-wide recalibrator (tests; None restores the
    lazy default). Returns the previous one, uninstalled from the
    model so its corrections stop applying."""
    global _default_recalibrator
    with _default_rec_lock:
        previous = _default_recalibrator
        _default_recalibrator = recalibrator
    if previous is not None:
        previous.uninstall()
    return previous
