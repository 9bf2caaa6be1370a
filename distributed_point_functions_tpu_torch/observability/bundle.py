"""Incident debug bundles: capture process state the moment things
break. Copied from the JAX package's `observability/bundle.py` (stdlib
and `events` only).

A pager fires on an SLO hard breach, a breaker open, or a probe
bit-identity failure — and by the time a human attaches, the
interesting state (burn table, flight-recorder traces, journal tail,
probe history) has been evicted by newer traffic. A `BundleManager`
registered on those triggers snapshots everything into one directory
*at trigger time*, with the same guard rails as the SLO-triggered
auto-profiler (`autoprofile.py`):

* a **cooldown** (default 60 s) bounds capture frequency — a flapping
  trigger fires at most once per window;
* one capture at a time (a trigger arriving mid-capture is counted as
  suppressed, never queued);
* a bounded **retention ring** of the last N bundles — evicting a
  bundle deletes its directory, so disk usage is bounded too;
* the capture is **atomic**: sources are written into a dot-prefixed
  temp directory in the same parent, then `os.rename`d to the final
  name — a reader listing `/debugz` (or the directory) never sees a
  half-written bundle.

Bundle layout (one JSON file per registered source, snapshotted in
name order, plus a manifest):

    bundle-0001-probe_failure/
        manifest.json     {reason, context, ts_unix, seq, sources}
        statusz.json      the /statusz?format=json state (breakers,
                          brownout, SLO burn, phase reservoirs, ...)
        metrics.json      full metrics-registry export
        traces.json       flight-recorder dump (slowest/errors/recent)
        events.json       journal tail (the correlated timeline)
        probes.json       per-kind probe history
        ...               any other source the deployment registered

Sources are duck-typed zero-argument callables returning something
JSON-serializable; a source that raises is recorded in the manifest
instead of aborting the bundle (a capture during an incident must not
add to the incident). `AdminServer` auto-registers the standard set
when handed a manager (see `admin.py`); trigger adapters (`on_burn`,
`on_breaker_transition`, `on_probe_failure`) plug directly into the
hooks the rest of the stack already exposes.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

from . import events as events_mod

__all__ = ["BundleManager"]

_REASON_SAFE = re.compile(r"[^a-zA-Z0-9_.-]+")


class BundleManager:
    """Guarded incident-state capturer (see module docstring).

    `directory` defaults to a fresh temp dir; `clock` is injectable for
    deterministic cooldown tests; `async_capture=True` runs the capture
    on a daemon thread so the trigger site (often a breaker transition
    or an SLO scrape) is not blocked on disk writes.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        *,
        cooldown_s: float = 60.0,
        max_bundles: int = 8,
        name: str = "debug",
        sources: Optional[Dict[str, Callable[[], object]]] = None,
        journal=None,
        clock=time.monotonic,
        async_capture: bool = False,
    ):
        self._dir = (
            directory
            if directory is not None
            else tempfile.mkdtemp(prefix=f"dpf-bundles-{name}-")
        )
        os.makedirs(self._dir, exist_ok=True)
        self._cooldown_s = float(cooldown_s)
        self._name = name
        self._journal = journal
        self._clock = clock
        self._async = async_capture
        self._lock = threading.Lock()
        self._in_flight = False
        self._last_fire: Optional[float] = None
        self._bundles = collections.deque(maxlen=max(1, max_bundles))
        self._counter = 0
        self._fired = 0
        self._errors = 0
        self._suppressed_cooldown = 0
        self._suppressed_inflight = 0
        self._sources: Dict[str, Callable[[], object]] = dict(sources or {})

    @property
    def directory(self) -> str:
        return self._dir

    def add_source(self, name: str, fn: Callable[[], object]) -> None:
        """Register a snapshot source: `fn()` -> JSON-serializable."""
        with self._lock:
            self._sources[str(name)] = fn

    # -- trigger adapters ----------------------------------------------------

    def on_burn(self, record: dict) -> None:
        """`SloTracker.add_burn_listener` adapter: capture on *hard*
        burn transitions (soft objectives are advisory)."""
        if record.get("severity") == "hard":
            self.trigger(
                "slo_hard_breach",
                {
                    "objective": record.get("name"),
                    "metric": record.get("metric"),
                    "observed": record.get("observed"),
                    "threshold": record.get("threshold"),
                },
            )

    def on_breaker_transition(self, old: str, new: str) -> None:
        """`CircuitBreaker.on_transition` adapter: capture on open."""
        if new == "open":
            self.trigger("breaker_open", {"old": old, "new": new})

    def on_probe_failure(self, record: dict) -> None:
        """`Prober.add_failure_listener` adapter."""
        context = {
            k: record.get(k) for k in ("kind", "status", "detail", "seq")
        }
        self.trigger("probe_failure", context)

    # -- capture ------------------------------------------------------------

    def trigger(
        self, reason: str, context: Optional[dict] = None
    ) -> Optional[dict]:
        """Request a capture; returns the bundle entry, or None when
        suppressed (cooldown / in-flight) or deferred to the capture
        thread (`async_capture=True`)."""
        now = self._clock()
        with self._lock:
            if self._in_flight:
                self._suppressed_inflight += 1
                return None
            if (
                self._last_fire is not None
                and now - self._last_fire < self._cooldown_s
            ):
                self._suppressed_cooldown += 1
                return None
            self._in_flight = True
            self._last_fire = now
            self._counter += 1
            seq = self._counter
        if self._async:
            threading.Thread(
                target=self._capture,
                args=(reason, context, seq),
                daemon=True,
                name=f"{self._name}-bundle",
            ).start()
            return None
        return self._capture(reason, context, seq)

    def _capture(
        self, reason: str, context: Optional[dict], seq: int
    ) -> dict:
        entry = {
            "seq": seq,
            "ts_unix": round(time.time(), 3),
            "reason": str(reason),
        }
        evicted = None
        try:
            safe = _REASON_SAFE.sub("_", str(reason))[:48] or "trigger"
            final_name = f"bundle-{seq:04d}-{safe}"
            # Atomicity: everything lands in a dot-prefixed sibling
            # first; the rename is the commit point, so a directory
            # listing only ever shows complete bundles.
            tmp = tempfile.mkdtemp(prefix=f".tmp-{final_name}-", dir=self._dir)
            with self._lock:
                sources = dict(self._sources)
            manifest = {
                "seq": seq,
                "reason": str(reason),
                "context": context,
                "ts_unix": entry["ts_unix"],
                "sources": {},
            }
            for name, fn in sorted(sources.items()):
                try:
                    data = fn()
                    with open(os.path.join(tmp, f"{name}.json"), "w") as f:
                        json.dump(data, f, indent=2, default=str)
                    manifest["sources"][name] = "ok"
                except Exception as e:  # noqa: BLE001 - partial > none
                    manifest["sources"][name] = (
                        f"{type(e).__name__}: {e}"[:200]
                    )
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2, default=str)
            final = os.path.join(self._dir, final_name)
            os.rename(tmp, final)
            entry["path"] = final
            entry["sources"] = manifest["sources"]
            journal = (
                self._journal
                if self._journal is not None
                else events_mod.default_journal()
            )
            journal.emit(
                "bundle.captured",
                f"{reason} -> {final_name}",
                severity="warning",
                reason=str(reason),
                path=final,
            )
        except Exception as e:  # noqa: BLE001 - a failed capture is an entry
            entry["error"] = f"{type(e).__name__}: {e}"[:200]
            with self._lock:
                self._errors += 1
        finally:
            with self._lock:
                self._fired += 1
                if len(self._bundles) == self._bundles.maxlen:
                    evicted = self._bundles[0]
                self._bundles.append(entry)
                self._in_flight = False
        if evicted is not None and evicted.get("path"):
            # Retention ring: the evicted bundle's directory goes too.
            shutil.rmtree(evicted["path"], ignore_errors=True)
        return entry

    # -- reading ------------------------------------------------------------

    def bundles(self) -> list:
        with self._lock:
            return [dict(b) for b in self._bundles]

    def export(self) -> dict:
        with self._lock:
            return {
                "directory": self._dir,
                "cooldown_s": self._cooldown_s,
                "max_bundles": self._bundles.maxlen,
                "fired": self._fired,
                "errors": self._errors,
                "in_flight": self._in_flight,
                "suppressed_cooldown": self._suppressed_cooldown,
                "suppressed_inflight": self._suppressed_inflight,
                "sources": sorted(self._sources),
                "bundles": [dict(b) for b in self._bundles],
            }
