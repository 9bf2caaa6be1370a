"""The capacity model of the port's serving work and the admission
control built on it (the JAX package's `capacity/`):

* `model` -- `CapacityModel`: dense PIR's selection bytes per tier, the
  heavy-hitters frontier, and the prices of serving requests (dense and
  sparse keys) and heavy-hitters levels in device-ms, calibrated from
  measured throughput (`calibration.py`);
* `admission` -- cost-aware admission for the serving batcher: per-tenant
  token buckets, a weighted-fair queue, shed-early on the queue's drain
  estimate with a retry-after hint, and the predictive governor;
* `brownout` -- the escalating, auto-reverting ladder of load-shed steps
  (shed low priority, cap batches, force a cheaper tier, critical only);
* `recalibrate` -- clamped per-workload correction factors learned from
  the cost ledger's drift windows, with a kill switch (`set_enabled`);
  `CapacityAccuracy` bundles the ledger, the model and the recalibrator.

Capacity sits below `pir/`, `serving/` and `heavy_hitters/` and never
imports a workload.
"""

from .admission import (
    AdmissionController,
    AdmissionDecision,
    PredictiveGovernor,
    ShedReason,
    TenantPolicy,
    TokenBucket,
    WeightedFairQueue,
)
from .brownout import BROWNOUT_STEPS, BrownoutController
from .calibration import ThroughputCalibration
from .model import (
    CapacityModel,
    LevelChunking,
    WorkCost,
    default_capacity_model,
    set_default_capacity_model,
)
from .recalibrate import (
    CapacityAccuracy,
    Recalibrator,
    default_recalibrator,
    set_default_recalibrator,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "BROWNOUT_STEPS",
    "BrownoutController",
    "CapacityAccuracy",
    "CapacityModel",
    "LevelChunking",
    "PredictiveGovernor",
    "Recalibrator",
    "ShedReason",
    "TenantPolicy",
    "ThroughputCalibration",
    "TokenBucket",
    "WeightedFairQueue",
    "WorkCost",
    "default_capacity_model",
    "default_recalibrator",
    "set_default_capacity_model",
    "set_default_recalibrator",
]
