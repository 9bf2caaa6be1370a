"""The port's utilization tracker and workload observatory against the
JAX package's, on the CPU.

The same scripted observations, from a numpy seed and under one fake
clock, go to both packages; the exports must be equal: the tracker's
windows, totals, bubble percentiles, threads, shards and stragglers
(its journal events too), and the observatory's sketch, top keys, Zipf
fit, hot share, tenants, histograms and periodicity. The helpers
(`CountMinSketch`, `TopKTracker`, `fit_zipf_exponent`,
`detect_periodicity`) are held apart as well. No XLA program runs here.
"""

import numpy as np
import pytest

from distributed_point_functions_tpu.observability import events as jevents
from distributed_point_functions_tpu.observability import utilization as jutil
from distributed_point_functions_tpu.observability import workload as jwork
from distributed_point_functions_tpu_torch.observability import events
from distributed_point_functions_tpu_torch.observability import utilization as util
from distributed_point_functions_tpu_torch.observability import workload as work

SEED = 1515


class Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _drive_tracker(mod, ev_mod, script):
    clock = Clock()
    journal = ev_mod.EventJournal(capacity=64)
    tracker = mod.UtilizationTracker(window_s=1.0, max_windows=16, straggler_band=0.2,
                                     straggler_min_busy_s=0.01, clock=clock,
                                     journal=journal)
    causes = list(mod.BUBBLE_CAUSES) + ["unknown_cause"]
    log = []
    for op, x, k in script:
        if op == 0:
            tracker.record_busy(x * 0.05, thread=["worker", "completer"][k % 2])
        elif op == 1:
            tracker.record_idle(causes[k % len(causes)], x * 0.03, thread="worker")
        elif op == 2:
            tracker.record_shard_busy(k % 4, x * 0.08 * (1 + (k % 4 == 0)))
        elif op == 3:
            with tracker.busy("leader"):
                clock.t += x * 0.01
        elif op == 4:
            with tracker.idle("helper_rtt", "leader"):
                clock.t += x * 0.01
        else:
            clock.t += x * 0.2
        if op == 5 and k == 0:
            log.append(tracker.last_duty_cycle_pct())
    log.append(tracker.export())
    log.append([(e["kind"], e["message"], e.get("fields")) for e in journal.tail(64)])
    tracker.reset()
    log.append(tracker.export())
    return log


def test_utilization_export_equals_jax():
    rng = np.random.default_rng(SEED)
    script = [(int(rng.integers(0, 6)), float(rng.random()), int(rng.integers(0, 9)))
              for _ in range(800)]
    jlog = _drive_tracker(jutil, jevents, script)
    log = _drive_tracker(util, events, script)
    assert log == jlog
    export = log[-3]
    assert export["windows"] and export["stragglers"] > 0
    assert set(export["totals"]["idle_s"]) <= set(util.BUBBLE_CAUSES)
    assert "other" in export["totals"]["idle_s"]  # the unknown cause


def test_utilization_disabled_records_nothing():
    tracker = util.UtilizationTracker(clock=Clock())
    tracker.enabled = False
    tracker.record_busy(1.0)
    tracker.record_idle("empty_queue", 1.0)
    assert tracker.export()["totals"]["busy_s"] == 0.0
    with pytest.raises(ValueError):
        util.UtilizationTracker(window_s=0)


def _zipf_keys(rng, n, s=1.1, universe=5000):
    ranks = np.arange(1, universe + 1)
    p = ranks ** -s
    return rng.choice(universe, size=n, p=p / p.sum()).tolist()


class Store:
    """A duck-typed time-series store: one tier of 64 one-second slots
    holding a period-8 rate series."""

    tiers = [(1.0, 64)]

    def query_range(self, series, start, end, tier=0, now=None):
        return 1.0, [(start + i, 10.0 + (5.0 if i % 8 < 2 else 0.0) + 0.01 * i)
                     for i in range(64)]


def _drive_observatory(mod, script):
    clock = Clock()
    obs = mod.WorkloadObservatory(sketch_width=256, sketch_depth=4, top_k=32,
                                  max_tenants=3, store=Store(), clock=clock, seed=7)
    for dt, tenant, keys, deadline, indices in script:
        clock.t += dt
        obs.observe(num_keys=keys, tenant=tenant, key_indices=indices,
                    deadline_s=deadline)
    return [obs.export(), obs.gauge_source(), obs.approx_bytes(),
            [obs.sketch.estimate(k) for k in range(64)], obs.topk.items()]


def test_workload_export_equals_jax():
    rng = np.random.default_rng(SEED)
    keys = _zipf_keys(rng, 6000, s=1.4, universe=2000)
    script = []
    for i in range(0, 6000, 6):
        script.append((float(rng.exponential(0.01)), f"t{int(rng.integers(0, 5))}",
                       int(rng.integers(1, 130)),
                       None if rng.random() < 0.2 else float(rng.random() * 3),
                       keys[i:i + 6] if rng.random() < 0.9 else None))
    jout = _drive_observatory(jwork, script)
    out = _drive_observatory(work, script)
    assert out == jout
    export = out[0]
    assert export["zipf_exponent"] is not None and export["hot_share_pct"] > 0
    assert export["periodicity"]["lag"] == 8
    assert "__other__" in export["tenants"] and export["within_budget"]


def test_workload_helpers_equal_jax():
    rng = np.random.default_rng(SEED + 1)
    for _ in range(20):
        counts = sorted(rng.integers(0, 1000, int(rng.integers(0, 40))).tolist(),
                        reverse=True)
        assert work.fit_zipf_exponent(counts) == jwork.fit_zipf_exponent(counts)
        series = [None if rng.random() < 0.1 else float(v)
                  for v in np.sin(np.arange(48) * 2 * np.pi / int(rng.integers(3, 12)))
                  + rng.random(48) * 0.3]
        assert (work.detect_periodicity(series, 10.0)
                == jwork.detect_periodicity(series, 10.0))
    sketch, jsketch = work.CountMinSketch(64, 3, seed=5), jwork.CountMinSketch(64, 3, seed=5)
    top, jtop = work.TopKTracker(8), jwork.TopKTracker(8)
    for k in _zipf_keys(rng, 3000, universe=500):
        for s in (sketch, jsketch, top, jtop):
            s.add(k)
    assert [sketch.estimate(k) for k in range(500)] == [jsketch.estimate(k) for k in range(500)]
    assert sketch.export() == jsketch.export() and top.items() == jtop.items()
    with pytest.raises(ValueError):
        work.CountMinSketch(4)
