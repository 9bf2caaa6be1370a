"""Federation: merge many replicas' telemetry into one fleet view.

A copy of the JAX package's `observability/federation.py` (stdlib only).
A fleet runs N replicas in one process, and every observability surface
(metrics registries, the event journal, the time-series store) is per
replica. This module is the pure-merge half of the fleet telemetry
plane: given the *exports* of N replicas' registries and journals --
plain dicts, collected by `fleet/telemetry.py` in the process, or by a
scraper over the network -- produce one merged metrics view with
`replica` attribution and one causally ordered cross-replica event
timeline.

Merge rules:

    counters    sum across replicas (work adds)
    gauges      sum across replicas (queue depths, in-flight, bytes add)
                — except names ending in one of `MEAN_GAUGE_SUFFIXES`
                (`_pct`, `_ratio`, `_efficiency`, `_factor`), which are
                averaged: a fleet of three replicas at 90% duty cycle is
                at 90%, not 270%.
    histograms  bucket-wise sum of cumulative counts (buckets are the
                mergeable shape — reservoirs are per-process and cannot
                be concatenated honestly across hosts), `count`/`sum`
                added, `max` maxed, and merged p50/p95/p99 *estimated*
                from the merged cumulative buckets by linear
                interpolation within the winning bucket. Only
                same-bucket-layout histograms merge; layout conflicts
                are surfaced in `skipped`, never silently averaged.

Clock rebase (the timeline half): events carry both `t_wall` and
`t_mono`. Monotonic clocks order one replica's events perfectly but
share no epoch across processes or hosts; wall clocks roughly agree
(NTP) but can step backwards, which would reorder a causal story. So
each replica's journal gets one constant offset — the *median* of
`t_wall - t_mono` over its events, robust to a minority of stepped wall
stamps — and every event is rebased to `t_fleet = t_mono + offset`.
A constant per-replica offset preserves each replica's internal
monotonic order exactly; the median anchors replicas to one another on
the wall clock. The merged sort key is `(t_fleet, replica, seq)`, so
ties across replicas break deterministically and intra-replica order is
provably stable.

Layering: stdlib only. Nothing here imports serving/ or fleet/ -- inputs
are exports (dicts).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MEAN_GAUGE_SUFFIXES",
    "gauge_rule",
    "label_replica",
    "merge_metrics",
    "merge_histograms",
    "merged_flat",
    "percentile_from_buckets",
    "rebase_offset",
    "merge_timelines",
    "merge_workloads",
]

# Gauges whose unit is a proportion: summing them across replicas is a
# category error, so the fleet row is the mean of the replica rows.
MEAN_GAUGE_SUFFIXES = ("_pct", "_ratio", "_efficiency", "_factor")


def gauge_rule(name: str) -> str:
    """Merge rule ("sum" | "mean") for gauge `name` (base name, labels
    stripped by the caller or tolerated here)."""
    base = name.split("{", 1)[0]
    if base.endswith(MEAN_GAUGE_SUFFIXES):
        return "mean"
    return "sum"


def label_replica(name: str, replica: str) -> str:
    """Re-label instrument `name` with a `replica=` pair, preserving the
    sorted-keys convention of `serving.metrics.labeled_name`."""
    if name.endswith("}") and "{" in name:
        base, _, inner = name.partition("{")
        pairs = [p for p in inner[:-1].split(",") if p]
        pairs.append(f"replica={replica}")
        pairs.sort()
        return f"{base}{{{','.join(pairs)}}}"
    return f"{name}{{replica={replica}}}"


def percentile_from_buckets(
    buckets: Dict[str, int], count: int, p: float
) -> Optional[float]:
    """Estimate percentile `p` from cumulative-ready bucket counts
    (`{upper_bound: observations_in_bucket, "+inf": n}`), Prometheus
    `histogram_quantile` style: find the bucket the rank lands in and
    interpolate linearly inside it. `+inf` observations clamp to the
    largest finite bound (the honest answer without a reservoir)."""
    if count <= 0:
        return None
    finite = sorted(
        (float(b), int(c)) for b, c in buckets.items() if b != "+inf"
    )
    rank = (p / 100.0) * count
    cumulative = 0
    lower = 0.0
    for bound, in_bucket in finite:
        if cumulative + in_bucket >= rank and in_bucket > 0:
            frac = (rank - cumulative) / in_bucket
            return round(lower + (bound - lower) * min(1.0, max(0.0, frac)), 4)
        cumulative += in_bucket
        lower = bound
    # Rank lives in +inf: clamp to the largest finite bound.
    return round(finite[-1][0], 4) if finite else None


def merge_histograms(per_replica: Dict[str, dict]) -> Optional[dict]:
    """Merge one instrument's per-replica histogram exports. Returns
    None when bucket layouts disagree (caller records it in `skipped`)."""
    layouts = {
        tuple(sorted(h.get("buckets", {}))) for h in per_replica.values()
    }
    if len(layouts) != 1:
        return None
    merged_buckets: Dict[str, int] = {}
    count = 0
    total = 0.0
    maxes = []
    for h in per_replica.values():
        count += int(h.get("count", 0))
        total += float(h.get("sum", 0.0))
        if h.get("max") is not None:
            maxes.append(float(h["max"]))
        for bound, c in h.get("buckets", {}).items():
            merged_buckets[bound] = merged_buckets.get(bound, 0) + int(c)
    return {
        "count": count,
        "sum": round(total, 4),
        "mean": round(total / count, 4) if count else None,
        "p50": percentile_from_buckets(merged_buckets, count, 50),
        "p95": percentile_from_buckets(merged_buckets, count, 95),
        "p99": percentile_from_buckets(merged_buckets, count, 99),
        "max": round(max(maxes), 4) if maxes else None,
        "buckets": merged_buckets,
        "rule": "bucket_merge",
        "replicas": sorted(per_replica),
    }


def merge_metrics(
    exports: Dict[str, dict], per_replica_rows: bool = True
) -> dict:
    """Merge `{replica_id: registry_export}` into one fleet view.

    Returns `{"replicas": [...], "counters": {...}, "gauges": {...},
    "histograms": {...}, "skipped": [...]}` where each merged row is
    `{"value"/..., "rule", "per_replica": {rid: v}}`. With
    `per_replica_rows`, a flat `rows` section additionally exposes every
    constituent as `name{replica=rid}` — the shape the Prometheus
    renderer and the admin text table both consume directly.
    """
    replicas = sorted(exports)
    counters: Dict[str, dict] = {}
    gauges: Dict[str, dict] = {}
    histograms: Dict[str, dict] = {}
    skipped: List[str] = []

    by_name: Dict[Tuple[str, str], Dict[str, object]] = {}
    for rid in replicas:
        export = exports[rid] or {}
        for kind in ("counters", "gauges", "histograms"):
            for name, value in (export.get(kind) or {}).items():
                by_name.setdefault((kind, name), {})[rid] = value

    for (kind, name), values in sorted(by_name.items()):
        if kind == "counters":
            counters[name] = {
                "value": sum(values.values()),
                "rule": "sum",
                "per_replica": dict(sorted(values.items())),
            }
        elif kind == "gauges":
            rule = gauge_rule(name)
            nums = [float(v) for v in values.values()]
            merged = (
                statistics.fmean(nums) if rule == "mean" else sum(nums)
            )
            gauges[name] = {
                "value": round(merged, 6),
                "rule": rule,
                "per_replica": dict(sorted(values.items())),
            }
        else:
            merged_hist = merge_histograms(values)
            if merged_hist is None:
                skipped.append(name)
                continue
            histograms[name] = merged_hist

    out = {
        "replicas": replicas,
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "skipped": sorted(skipped),
    }
    if per_replica_rows:
        rows: Dict[str, dict] = {"counters": {}, "gauges": {}}
        for name, row in counters.items():
            for rid, v in row["per_replica"].items():
                rows["counters"][label_replica(name, rid)] = v
        for name, row in gauges.items():
            for rid, v in row["per_replica"].items():
                rows["gauges"][label_replica(name, rid)] = v
        out["rows"] = rows
    return out


def merged_flat(exports: Dict[str, dict]) -> dict:
    """The merged view flattened back to plain registry-export shape
    (`{"counters": {name: v}, "gauges": ..., "histograms": ...}`) so
    anything that grades a registry export — `SloTracker`, the anomaly
    watch — can grade the fleet as if it were one process."""
    merged = merge_metrics(exports, per_replica_rows=False)
    return {
        "counters": {
            k: row["value"] for k, row in merged["counters"].items()
        },
        "gauges": {k: row["value"] for k, row in merged["gauges"].items()},
        "histograms": dict(merged["histograms"]),
    }


# ---------------------------------------------------------------------------
# Workload federation
# ---------------------------------------------------------------------------


def merge_workloads(exports: Dict[str, dict]) -> dict:
    """Merge `{replica_id: WorkloadObservatory.export()}` into one
    fleet traffic characterization.

    Rules follow the metric table's spirit: arrival rates and
    observation/key counts *sum* (a fleet serves the union of its
    replicas' traffic); per-request shape numbers — burstiness CV² and
    the Zipf exponent — are observation-weighted *means* (each replica
    sees an unbiased sample of the same request population under a
    routing front door); top-key tables merge by summing per-key counts
    and errors across replicas, then re-ranking; deadline/batch-size
    histograms bucket-sum (same fixed layout by construction). Sketches
    themselves do not cross the wire — only their totals and the top-K
    digests do — so the merged `hot_share_pct` is recomputed from the
    merged table against the summed sketch totals."""
    replicas = sorted(exports)
    observations = 0
    keys_observed = 0
    sketch_total = 0
    rate_sum = 0.0
    rate_seen = False
    cv2_num = zipf_num = 0.0
    cv2_w = zipf_w = 0
    top: Dict[object, Dict[str, int]] = {}
    tenants: Dict[str, dict] = {}
    deadline: Dict[str, int] = {}
    batch: Dict[str, int] = {}
    deadline_n = 0
    for rid in replicas:
        export = exports[rid] or {}
        obs = int(export.get("observations") or 0)
        observations += obs
        keys_observed += int(export.get("keys_observed") or 0)
        sketch_total += int(
            (export.get("sketch") or {}).get("total") or 0
        )
        if export.get("rate_qps") is not None:
            rate_sum += float(export["rate_qps"])
            rate_seen = True
        if export.get("burstiness_cv2") is not None and obs:
            cv2_num += float(export["burstiness_cv2"]) * obs
            cv2_w += obs
        if export.get("zipf_exponent") is not None and obs:
            zipf_num += float(export["zipf_exponent"]) * obs
            zipf_w += obs
        for entry in export.get("top_keys") or []:
            row = top.setdefault(
                entry["key"], {"count": 0, "error": 0}
            )
            row["count"] += int(entry.get("count") or 0)
            row["error"] += int(entry.get("error") or 0)
        for tenant, row in (export.get("tenants") or {}).items():
            merged = tenants.setdefault(
                tenant,
                {"observations": 0, "keys": 0, "rate_qps": None},
            )
            merged["observations"] += int(row.get("observations") or 0)
            merged["keys"] += int(row.get("keys") or 0)
            if row.get("rate_qps") is not None:
                merged["rate_qps"] = round(
                    (merged["rate_qps"] or 0.0) + float(row["rate_qps"]),
                    4,
                )
        for target, source_key in ((deadline, "deadline_ms"),
                                   (batch, "batch_keys")):
            hist = export.get(source_key) or {}
            for bound, n in (hist.get("buckets") or {}).items():
                target[bound] = target.get(bound, 0) + int(n)
        deadline_n += int(
            (export.get("deadline_ms") or {}).get("count") or 0
        )
    top_keys = sorted(
        (
            {"key": key, "count": row["count"], "error": row["error"]}
            for key, row in top.items()
        ),
        key=lambda r: (-r["count"], str(r["key"])),
    )
    for row in top_keys:
        row["share_pct"] = round(
            row["count"] / sketch_total * 100.0, 2
        ) if sketch_total else 0.0
    for tenant, row in tenants.items():
        row["share_pct"] = round(
            row["observations"] / observations * 100.0, 2
        ) if observations else 0.0
    covered = sum(
        max(0, row["count"] - row["error"]) for row in top_keys
    )
    return {
        "replicas": replicas,
        "observations": observations,
        "keys_observed": keys_observed,
        "rate_qps": round(rate_sum, 4) if rate_seen else None,
        "burstiness_cv2": (
            round(cv2_num / cv2_w, 4) if cv2_w else None
        ),
        "zipf_exponent": (
            round(zipf_num / zipf_w, 4) if zipf_w else None
        ),
        "hot_share_pct": (
            round(min(100.0, covered / sketch_total * 100.0), 2)
            if sketch_total else None
        ),
        "top_keys": top_keys,
        "tenants": dict(sorted(tenants.items())),
        "deadline_ms": {"count": deadline_n, "buckets": deadline},
        "batch_keys": {"count": observations, "buckets": batch},
    }


# ---------------------------------------------------------------------------
# Timeline federation
# ---------------------------------------------------------------------------


def rebase_offset(events: Iterable[dict]) -> Optional[float]:
    """One constant wall-anchoring offset for a replica's journal: the
    median of `t_wall - t_mono` over events that carry both stamps.
    None with no usable events (caller falls back to raw `t_wall`)."""
    deltas = [
        float(e["t_wall"]) - float(e["t_mono"])
        for e in events
        if e.get("t_wall") is not None and e.get("t_mono") is not None
    ]
    if not deltas:
        return None
    return statistics.median(deltas)


def merge_timelines(
    journals: Dict[str, object],
    n: Optional[int] = None,
    kind: Optional[str] = None,
    min_severity: Optional[str] = None,
) -> dict:
    """Interleave `{replica_id: journal_export_or_event_list}` into one
    causally ordered fleet timeline.

    Each event gains `replica` (the journal's key, unless the emitter
    already stamped one — scoped journals do) and `t_fleet` (the
    monotonic-rebased timestamp; see module docstring). Events sort by
    `(t_fleet, replica, seq)`. `kind` filters exact-or-dotted-prefix
    like `EventJournal.tail`; `n` keeps the newest n after filtering.

    Returns `{"replicas", "offsets", "count", "events"}` so the caller
    can show the rebase it applied (the offsets are the audit trail for
    "why does replica b's event sort before replica a's").
    """
    offsets: Dict[str, float] = {}
    merged: List[dict] = []
    for rid in sorted(journals):
        source = journals[rid]
        events = (
            source.get("events", [])
            if isinstance(source, dict)
            else list(source)
        )
        offset = rebase_offset(events)
        if offset is not None:
            offsets[rid] = round(offset, 6)
        for e in events:
            event = dict(e)
            event.setdefault("replica", rid)
            if offset is not None and event.get("t_mono") is not None:
                event["t_fleet"] = round(float(event["t_mono"]) + offset, 6)
            else:
                event["t_fleet"] = event.get("t_wall")
            merged.append(event)
    if kind:
        merged = [
            e for e in merged
            if e["kind"] == kind or e["kind"].startswith(kind + ".")
        ]
    if min_severity:
        severities = ("info", "warning", "error")
        floor = severities.index(min_severity)
        merged = [
            e for e in merged
            if severities.index(e.get("severity", "info")) >= floor
        ]
    merged.sort(
        key=lambda e: (
            e["t_fleet"] if e["t_fleet"] is not None else 0.0,
            str(e.get("replica", "")),
            e.get("seq", 0),
        )
    )
    if n is not None:
        merged = merged[-max(0, int(n)):]
    return {
        "replicas": sorted(journals),
        "offsets": offsets,
        "count": len(merged),
        "events": merged,
    }
