"""The port's `observability/federation.py` against the JAX package's.

The module is a copy: its code (the module less its docstring) is the
JAX package's, statement for statement. Each merge is then fed the same
exports, made from `np.random.default_rng(seed)`, in both packages and
must give equal outputs, with no tolerance: counters; gauges, some of
them proportions (`_pct`, `_ratio`, `_efficiency`, `_factor`) and some
labeled; histograms of one bucket layout and of conflicting layouts;
journals whose wall clocks step backwards; workload exports. A few cases
then hold the port to the merge rules themselves.
"""

import ast
import inspect

import numpy as np
import pytest

import distributed_point_functions_tpu.observability.federation as jfed
import distributed_point_functions_tpu_torch.observability as pobs
import distributed_point_functions_tpu_torch.observability.federation as pfed

SEEDS = range(6)
SUFFIXES = ("", "_pct", "_ratio", "_efficiency", "_factor", "_bytes")
LAYOUTS = (("1.0", "5.0", "25.0", "+inf"), ("2.0", "10.0", "+inf"))


def _code(module):
    """The module's AST less its docstring."""
    tree = ast.parse(inspect.getsource(module))
    tree.body = tree.body[1:]
    return ast.dump(tree)


def test_module_is_a_copy_of_the_jax_module():
    assert _code(pfed) == _code(jfed)
    assert pfed.__all__ == jfed.__all__
    assert set(pfed.__all__) <= set(pobs.__all__)


def _name(rng, prefix: str, suffix: str) -> str:
    name = f"{prefix}.m{int(rng.integers(0, 6))}{suffix}"
    if rng.random() < 0.3:
        name += f"{{party={'leader' if rng.random() < 0.5 else 'helper'}}}"
    return name


def _histogram(rng, layout):
    buckets = {b: int(rng.integers(0, 20)) for b in layout}
    count = sum(buckets.values())
    return {"count": count, "sum": float(rng.random() * 100 * count),
            "max": float(rng.random() * 50) if count else None,
            "p50": 1.0, "buckets": buckets}


def make_exports(seed: int, replicas: int = 3, conflicts: bool = True) -> dict:
    """{replica: registry export} with shared, partial and conflicting
    instruments."""
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(replicas):
        export = {"counters": {}, "gauges": {}, "histograms": {}}
        for _ in range(8):
            export["counters"][_name(rng, "c", "")] = int(rng.integers(0, 1000))
        for _ in range(10):
            suffix = SUFFIXES[int(rng.integers(0, len(SUFFIXES)))]
            export["gauges"][_name(rng, "g", suffix)] = float(rng.random() * 100)
        for h in range(4):
            # h = 3 is the conflicting instrument: its layout depends on r.
            layout = LAYOUTS[r % 2] if (conflicts and h == 3) else LAYOUTS[0]
            if rng.random() < 0.85:
                export["histograms"][f"h.lat{h}_ms"] = _histogram(rng, layout)
        out[f"r{r}"] = export
    if rng.random() < 0.5:
        out["r_empty"] = None
    return out


def make_journals(seed: int, replicas: int = 3, events: int = 12) -> dict:
    """{replica: journal export or event list}: monotonic clocks with
    their own epochs, wall clocks that agree within a few ms and step
    backwards now and then."""
    rng = np.random.default_rng(seed)
    kinds = ("snapshot.flip", "snapshot.drained", "breaker.transition",
             "fleet.replica_state", "service.degraded")
    out = {}
    for r in range(replicas):
        mono = float(rng.integers(0, 10_000))
        wall = 1.7e9 + float(rng.random())
        rows = []
        for seq in range(1, events + 1):
            step = float(rng.random() * 0.01)
            mono += step
            wall += step + (-0.5 if rng.random() < 0.15 else float(rng.random() * 1e-3))
            row = {"seq": seq, "kind": kinds[int(rng.integers(0, len(kinds)))],
                   "message": f"e{seq}",
                   "severity": ("info", "warning", "error")[int(rng.integers(0, 3))],
                   "t_wall": round(wall, 6), "t_mono": round(mono, 6)}
            if rng.random() < 0.1:
                row.pop("t_mono")
            if rng.random() < 0.2:
                row["replica"] = f"stamped{r}"
            rows.append(row)
        out[f"r{r}"] = {"events": rows} if r % 2 else rows
    return out


def make_workloads(seed: int, replicas: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(replicas):
        obs = int(rng.integers(0, 500))
        out[f"r{r}"] = {
            "observations": obs,
            "keys_observed": obs * int(rng.integers(1, 4)),
            "sketch": {"total": obs * 2},
            "rate_qps": float(rng.random() * 50) if rng.random() < 0.8 else None,
            "burstiness_cv2": float(rng.random() * 3) if rng.random() < 0.8 else None,
            "zipf_exponent": float(rng.random() * 2) if rng.random() < 0.7 else None,
            "top_keys": [{"key": int(k), "count": int(rng.integers(1, 60)),
                          "error": int(rng.integers(0, 3))}
                         for k in rng.choice(20, 5, replace=False)],
            "tenants": {t: {"observations": int(rng.integers(0, 100)),
                            "keys": int(rng.integers(0, 200)),
                            "rate_qps": float(rng.random() * 5)
                            if rng.random() < 0.7 else None}
                        for t in ("gold", "bronze", "free")[: 1 + r % 3]},
            "deadline_ms": {"count": obs, "buckets": {
                b: int(rng.integers(0, 30)) for b in ("10", "100", "+inf")}},
            "batch_keys": {"count": obs, "buckets": {
                b: int(rng.integers(0, 30)) for b in ("1", "8", "128", "+inf")}},
        }
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rows", [True, False])
def test_merge_metrics_equals_jax(seed, rows):
    exports = make_exports(seed)
    assert pfed.merge_metrics(exports, per_replica_rows=rows) == jfed.merge_metrics(
        exports, per_replica_rows=rows)


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_histograms_and_flat_equal_jax(seed):
    exports = make_exports(seed)
    for name in ("h.lat0_ms", "h.lat3_ms"):
        per_replica = {r: e["histograms"][name] for r, e in exports.items()
                       if e and name in e["histograms"]}
        assert pfed.merge_histograms(per_replica) == jfed.merge_histograms(per_replica)
        for p in (0, 50, 95, 99, 100):
            merged = jfed.merge_histograms(
                {r: h for r, h in per_replica.items() if h["buckets"].keys()
                 == dict.fromkeys(LAYOUTS[0]).keys()})
            if merged is not None:
                assert pfed.percentile_from_buckets(
                    merged["buckets"], merged["count"], p
                ) == jfed.percentile_from_buckets(merged["buckets"], merged["count"], p)
    assert pfed.merged_flat(exports) == jfed.merged_flat(exports)


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_workloads_equals_jax(seed):
    workloads = make_workloads(seed)
    assert pfed.merge_workloads(workloads) == jfed.merge_workloads(workloads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("filters", [
    {}, {"n": 7}, {"kind": "snapshot"}, {"kind": "fleet.replica_state"},
    {"min_severity": "warning"}, {"n": 3, "kind": "breaker", "min_severity": "info"},
])
def test_merge_timelines_equals_jax(seed, filters):
    journals = make_journals(seed)
    got = pfed.merge_timelines(journals, **filters)
    assert got == jfed.merge_timelines(journals, **filters)
    for rid, source in journals.items():
        events = source["events"] if isinstance(source, dict) else source
        assert pfed.rebase_offset(events) == jfed.rebase_offset(events)


@pytest.mark.parametrize("name", ["fleet.duty_cycle_pct", "x.hit_ratio",
                                  "feed_efficiency{replica=r0}", "scale_factor",
                                  "queue_depth", "bytes{role=leader}", "pct_total"])
def test_gauge_rule_and_label_replica_equal_jax(name):
    assert pfed.gauge_rule(name) == jfed.gauge_rule(name)
    assert pfed.label_replica(name, "r9") == jfed.label_replica(name, "r9")


def test_merge_rules():
    exports = {
        "a": {"counters": {"req": 3}, "gauges": {"duty_pct": 90.0, "depth": 2.0},
              "histograms": {"lat": {"count": 2, "sum": 3.0, "max": 2.0,
                                     "buckets": {"1.0": 1, "5.0": 1, "+inf": 0}},
                             "odd": {"count": 1, "sum": 1.0,
                                     "buckets": {"1.0": 1, "+inf": 0}}}},
        "b": {"counters": {"req": 4}, "gauges": {"duty_pct": 70.0, "depth": 5.0},
              "histograms": {"lat": {"count": 2, "sum": 9.0, "max": 7.0,
                                     "buckets": {"1.0": 0, "5.0": 1, "+inf": 1}},
                             "odd": {"count": 1, "sum": 1.0,
                                     "buckets": {"2.0": 1, "+inf": 0}}}},
    }
    merged = pfed.merge_metrics(exports)
    assert merged["counters"]["req"] == {"value": 7, "rule": "sum",
                                         "per_replica": {"a": 3, "b": 4}}
    assert merged["gauges"]["duty_pct"]["value"] == 80.0
    assert merged["gauges"]["duty_pct"]["rule"] == "mean"
    assert merged["gauges"]["depth"]["value"] == 7.0
    assert merged["histograms"]["lat"]["buckets"] == {"1.0": 1, "5.0": 2, "+inf": 1}
    assert merged["histograms"]["lat"]["count"] == 4
    assert merged["histograms"]["lat"]["max"] == 7.0
    assert merged["skipped"] == ["odd"]
    assert merged["rows"]["gauges"]["depth{replica=b}"] == 5.0


def test_timeline_rebase_keeps_each_replica_in_order():
    # Replica b's monotonic clock starts 1,000 s later; its wall clock
    # agrees with a's, one stamp stepped back a second.
    a = [{"seq": i, "kind": "k", "t_mono": 10.0 + i, "t_wall": 100.0 + i}
         for i in range(5)]
    b = [{"seq": i, "kind": "k", "t_mono": 1010.5 + i, "t_wall": 100.5 + i}
         for i in range(5)]
    b[2]["t_wall"] -= 1.0
    timeline = pfed.merge_timelines({"a": a, "b": {"events": b}})
    assert timeline["offsets"] == {"a": 90.0, "b": -910.0}
    order = [(e["replica"], e["seq"]) for e in timeline["events"]]
    assert order == [(r, i) for i in range(5) for r in ("a", "b")]
