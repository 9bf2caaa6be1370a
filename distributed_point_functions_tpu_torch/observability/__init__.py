"""Request observability of the serving runtime.

Copied from the JAX package (`tracing`, `phases`, `events`,
`propagation`, `critical_path`), and `device` rewritten on `torch.cuda`:

* `tracing` -- per-request spans with trace ids and a flight recorder;
* `phases` -- per-request latency attribution into a fixed taxonomy;
* `events` -- the journal of operational transitions (breaker flips,
  degraded mode, snapshot flips and drains);
* `propagation` -- the Leader -> Helper trace-context envelope,
  versions 1-3, byte-equal to the JAX package's so that either
  package's Leader talks to either's Helper;
* `critical_path` -- the Helper leg's skew estimate and its split into
  network, queue and compute;
* `device` -- first dispatches per bucket shape, device memory
  watermarks, and the host <-> device transfer ledger;
* `costmodel` and `slo` (copied) -- the cost ledger that joins the
  capacity model's price of each heavy-hitters level with its measured
  time and peak bytes, and the declarative objective that grades its
  drift;
* `utilization` and `workload` (copied) -- the device's duty cycle with
  typed idle bubbles (the batcher's busy time is its span on its CUDA
  stream), and the bounded-memory traffic characterization (count-min
  sketch, top-K, Zipf fit, per-tenant arrival rate and burstiness).

* `exposition`, `timeseries`, `forecast` and `bundle` (copied) -- the
  Prometheus text format, the in-process time-series store with its
  sampler and anomaly watch, the Holt forecaster with time-to-breach and
  trough windows, and incident debug bundles;
* `autoprofile` -- a `torch.profiler` capture when a latency objective
  starts to burn;
* `federation` (copied) -- the merge of N replicas' registry exports,
  workload exports and journals into one fleet view;
* `admin` -- the operator's HTTP endpoint over all of the above.

The layers run serving -> observability -> utils / robustness; nothing
here imports `pir/`, `ops/` or `serving/`.
"""

from .admin import AdminServer
from .autoprofile import AutoProfiler, capture_profile
from .bundle import BundleManager
from .exposition import parse_labeled_name, render_prometheus
from .federation import (
    MEAN_GAUGE_SUFFIXES,
    gauge_rule,
    label_replica,
    merge_histograms,
    merge_metrics,
    merge_timelines,
    merge_workloads,
    merged_flat,
    percentile_from_buckets,
    rebase_offset,
)
from .forecast import Forecaster, SeriesForecast, holt_fit
from .timeseries import (
    AnomalyWatch,
    MetricsSampler,
    TimeSeriesStore,
    render_sparklines,
    sparkline,
)

__all__ = [
    "AdminServer",
    "AnomalyWatch",
    "AutoProfiler",
    "BundleManager",
    "Forecaster",
    "MEAN_GAUGE_SUFFIXES",
    "MetricsSampler",
    "SeriesForecast",
    "TimeSeriesStore",
    "capture_profile",
    "gauge_rule",
    "holt_fit",
    "label_replica",
    "merge_histograms",
    "merge_metrics",
    "merge_timelines",
    "merge_workloads",
    "merged_flat",
    "parse_labeled_name",
    "percentile_from_buckets",
    "rebase_offset",
    "render_prometheus",
    "render_sparklines",
    "sparkline",
]
