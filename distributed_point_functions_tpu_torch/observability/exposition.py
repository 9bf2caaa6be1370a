"""Prometheus text exposition for the serving metrics registry, copied
from the JAX package's `observability/exposition.py` (stdlib only).

Renders a `serving.metrics.MetricsRegistry.export()` dict (duck-typed —
this layer never imports `serving/`) into the Prometheus text format
(version 0.0.4): `# TYPE` lines, cumulative `_bucket{le=...}` series
ending at `+Inf`, `_sum`/`_count` per histogram, and escaped label
values.

Instrument names follow the registry's labeling convention
(`serving/metrics.py`): a flat name may carry labels as a
`base{k=v,k2=v2}` suffix. The renderer splits that back into a
Prometheus metric `base` with label pairs, so per-role/per-level
instruments (`request_ms{role=leader}`) become one metric family with
labeled series instead of colliding flat names. Characters outside
`[a-zA-Z0-9_:]` in names (the registry's dotted names) sanitize to `_`.

Histogram exports may carry per-bucket **exemplars** (`{"exemplars":
{"50.0": {"value": 48.2, "trace_id": "...", "ts": ...}}}`); each lands
on its `_bucket` line in the OpenMetrics exemplar syntax —
`... # {trace_id="..."} 48.2 1700000000.0` — linking the bucket to the
flight-recorder trace that most recently filled it. Plain Prometheus
scrapers tolerate the suffix on the text format; OpenMetrics scrapers
ingest it.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["render_prometheus", "parse_labeled_name"]

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")
_LABELED = re.compile(r"^(?P<base>[^{]+)\{(?P<labels>.*)\}$")


def parse_labeled_name(name: str) -> Tuple[str, Dict[str, str]]:
    """Split the registry's `base{k=v,k2=v2}` convention into
    (base, labels). Names without a `{...}` suffix return ({}, no
    labels). Malformed label bodies degrade to a label-less name rather
    than raising — exposition must never take the scrape down."""
    m = _LABELED.match(name)
    if not m:
        return name, {}
    labels: Dict[str, str] = {}
    body = m.group("labels")
    for part in body.split(","):
        if not part.strip():
            continue
        k, sep, v = part.partition("=")
        if not sep or not k.strip():
            return name.replace("{", "_").replace("}", "_"), {}
        labels[k.strip()] = v.strip()
    return m.group("base"), labels


def _sanitize_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _sanitize_label(name: str) -> str:
    name = _LABEL_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_sanitize_label(k)}="{_escape_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt(value) -> str:
    f = float(value)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _bucket_bound(key: str) -> float:
    return math.inf if key == "+inf" else float(key)


def render_prometheus(
    export: dict, namespace: Optional[str] = "dpf"
) -> str:
    """Render one registry export dict to Prometheus text. Series with
    the same base name group under one `# TYPE` family; histogram
    buckets re-accumulate to the cumulative counts Prometheus expects
    (the registry stores per-bucket increments)."""
    prefix = f"{namespace}_" if namespace else ""
    families: Dict[str, dict] = {}

    def family(raw_base: str, kind: str) -> dict:
        base = prefix + _sanitize_name(raw_base)
        fam = families.setdefault(base, {"type": kind, "series": []})
        return fam

    for name, value in export.get("counters", {}).items():
        base, labels = parse_labeled_name(name)
        family(base, "counter")["series"].append(
            (prefix + _sanitize_name(base) + _render_labels(labels), value)
        )
    for name, value in export.get("gauges", {}).items():
        base, labels = parse_labeled_name(name)
        family(base, "gauge")["series"].append(
            (prefix + _sanitize_name(base) + _render_labels(labels), value)
        )
    for name, hist in export.get("histograms", {}).items():
        base, labels = parse_labeled_name(name)
        fam = family(base, "histogram")
        full = prefix + _sanitize_name(base)
        buckets = hist.get("buckets", {})
        exemplars = hist.get("exemplars", {})
        ordered = sorted(buckets.items(), key=lambda kv: _bucket_bound(kv[0]))
        cumulative = 0
        lines: List[Tuple[str, object]] = []
        for key, count in ordered:
            cumulative += int(count)
            le = "+Inf" if key == "+inf" else _fmt(_bucket_bound(key))
            line = (
                full
                + "_bucket"
                + _render_labels({**labels, "le": le}),
                cumulative,
            )
            exemplar = exemplars.get(key)
            if exemplar and exemplar.get("trace_id"):
                line = line + (_render_exemplar(exemplar),)
            lines.append(line)
        count = int(hist.get("count", 0))
        if not ordered or _bucket_bound(ordered[-1][0]) != math.inf:
            lines.append(
                (
                    full
                    + "_bucket"
                    + _render_labels({**labels, "le": "+Inf"}),
                    count,
                )
            )
        lines.append((full + "_sum" + _render_labels(labels),
                      hist.get("sum", 0.0)))
        lines.append((full + "_count" + _render_labels(labels), count))
        fam["series"].extend(lines)

    out: List[str] = []
    for base in sorted(families):
        fam = families[base]
        out.append(f"# TYPE {base} {fam['type']}")
        for series in fam["series"]:
            series_name, value = series[0], series[1]
            suffix = series[2] if len(series) > 2 else ""
            out.append(f"{series_name} {_fmt(value)}{suffix}")
    return "\n".join(out) + ("\n" if out else "")


def _render_exemplar(exemplar: dict) -> str:
    """OpenMetrics exemplar suffix for a `_bucket` line."""
    trace_id = _escape_value(str(exemplar["trace_id"]))
    suffix = f' # {{trace_id="{trace_id}"}} {_fmt(exemplar["value"])}'
    ts = exemplar.get("ts")
    if ts is not None:
        suffix += f" {_fmt(round(float(ts), 3))}"
    return suffix
