"""Replica fleet registry: N Leader/Helper pairs as one operable set.

A port of the JAX package's `fleet/registry.py`. Serving many users
means N non-colluding Leader/Helper pairs behind one front door -- the
CGKS'95 two-server model *replicated*. Everything below this module
already exists per pair (sessions, `SnapshotManager`, breaker,
prober, `CapacityModel`); the registry is the composition layer that
tracks which pairs may take traffic.

Each `Replica` bundles one pair's handles; the `ReplicaSet` assigns
each a health state:

    serving    healthy, in the router's candidate set
    staging    mid-rotation (generation N+1 staged, not yet flipped);
               still serving generation N
    draining   shed — existing work finishes, the router skips it
               (laggard rotation, open helper-leg breaker, stale
               probes, operator shed)
    dead       removed from rotation until an operator readmits it

State is *fed*, not polled: adding a replica subscribes to its
Leader's helper-leg breaker (`open` drains the replica — a pair whose
Helper is unreachable answers degraded shares no client can unmask —
and `closed` restores it), and `refresh()` applies the same probe
staleness rule `AdminServer._healthz` serves 503s with, so the
in-process view and the per-replica `/healthz` agree. Explicit
`shed`/`readmit`/`kill` cover the rotation coordinator and operators.

Every transition is journaled (`fleet.replica_state`) and kept in a
bounded history; `export()` is the `/fleetz` admin page and the fleet
debug-bundle source.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

from ..capacity.model import default_capacity_model
from ..observability import events as events_mod

__all__ = ["REPLICA_STATES", "Replica", "ReplicaSet"]

REPLICA_STATES = ("serving", "staging", "draining", "dead")


class Replica:
    """One Leader/Helper pair's handles, addressable by a stable id.

    `leader` is the pair's front session (`LeaderSession` or
    `PlainSession` — anything with `handle_request`/`server`/
    `metrics`); `helper` its Helper-side session when the pair is
    two-party. `leader_snapshots`/`helper_snapshots` are the parties'
    `SnapshotManager`s (rotation and per-request generation pinning
    need both); `prober` the pair's blackbox canary; `capacity` the
    pair's price model (defaults to the process model, which a
    single-process fleet shares). Construction stamps the replica id
    onto the capacity model so its price exports are attributable.
    """

    def __init__(
        self,
        replica_id: str,
        leader,
        helper=None,
        *,
        leader_snapshots=None,
        helper_snapshots=None,
        prober=None,
        capacity=None,
    ):
        self.replica_id = str(replica_id)
        self.leader = leader
        self.helper = helper
        self.snapshots = leader_snapshots
        self.helper_snapshots = helper_snapshots
        self.prober = prober
        self.capacity = (
            capacity if capacity is not None else default_capacity_model()
        )
        self.capacity.set_replica(self.replica_id)

    # -- live readings -------------------------------------------------------

    def serving_generation(self) -> int:
        if self.snapshots is not None:
            return self.snapshots.serving_generation()
        db = getattr(getattr(self.leader, "server", None), "database", None)
        return int(getattr(db, "generation", 0))

    def staging_generation(self) -> Optional[int]:
        if self.snapshots is not None:
            return self.snapshots.staging_generation()
        return None

    def managers(self) -> List:
        """The pair's SnapshotManagers (leader first), for pinning."""
        return [
            m
            for m in (self.snapshots, self.helper_snapshots)
            if m is not None
        ]

    def queue_depth(self) -> float:
        """Live admission-queue depth summed over the pair's batchers
        (the `*.batcher.queue_depth` gauges both sessions already
        export)."""
        depth = 0.0
        for session in (self.leader, self.helper):
            metrics = getattr(session, "metrics", None)
            if metrics is None:
                continue
            gauges = metrics.export().get("gauges", {})
            depth += sum(
                v
                for k, v in gauges.items()
                if k.split("{", 1)[0].endswith(".queue_depth")
            )
        return depth

    def price(self, num_keys: int = 8) -> dict:
        """This replica's price card (see `CapacityModel.price_export`)."""
        num_blocks = getattr(
            getattr(self.leader, "server", None), "_num_blocks", None
        )
        return self.capacity.price_export(num_keys, num_blocks)

    def degraded(self) -> bool:
        return bool(getattr(self.leader, "degraded", False))

    def probe_fresh(self) -> Optional[bool]:
        """Whether every identity probe kind is fresh (None without a
        prober — freshness then cannot gate health)."""
        if self.prober is None:
            return None
        freshness = self.prober.freshness()
        return all(
            v.get("fresh", True)
            for v in freshness.values()
            if v.get("identity")
        )

    def export(self) -> dict:
        breaker = None
        breaker_export = getattr(self.leader, "breaker_export", None)
        if callable(breaker_export):
            breaker = breaker_export()
        return {
            "replica_id": self.replica_id,
            "role": "pair" if self.helper is not None else "plain",
            "serving_generation": self.serving_generation(),
            "staging_generation": self.staging_generation(),
            "degraded": self.degraded(),
            "queue_depth": self.queue_depth(),
            "price": self.price(),
            "breaker": breaker,
            "probe_fresh": self.probe_fresh(),
        }


class ReplicaSet:
    """Health-stated registry of the fleet's replicas (module docstring
    has the state meanings). Thread-safe; transitions are journaled
    and counted, `export()` backs `/fleetz`."""

    def __init__(
        self,
        *,
        journal=None,
        clock=time.monotonic,
        history: int = 64,
    ):
        self._journal = journal
        self._clock = clock
        self._lock = threading.RLock()
        self._replicas: "collections.OrderedDict[str, Replica]" = (
            collections.OrderedDict()
        )
        self._states: Dict[str, str] = {}
        self._reasons: Dict[str, str] = {}
        self._since: Dict[str, float] = {}
        self._history: collections.deque = collections.deque(
            maxlen=max(1, history)
        )
        self._sheds = 0
        self._readmissions = 0
        self._deaths = 0
        self._listeners: List[Callable[[str, str, str, str], None]] = []

    # -- membership ----------------------------------------------------------

    def add(self, replica: Replica, state: str = "serving") -> Replica:
        """Register a replica and subscribe to its Leader's helper-leg
        breaker: `open` drains it (a Helperless pair serves shares no
        client can unmask), `closed` restores it."""
        if state not in REPLICA_STATES:
            raise ValueError(f"unknown replica state {state!r}")
        rid = replica.replica_id
        with self._lock:
            if rid in self._replicas:
                raise ValueError(f"replica {rid!r} already registered")
            self._replicas[rid] = replica
            self._states[rid] = state
            self._reasons[rid] = "registered"
            self._since[rid] = self._clock()
        breaker = getattr(replica.leader, "breaker", None)
        if breaker is not None:
            breaker.on_transition(
                lambda old, new, rid=rid: self._on_breaker(rid, old, new)
            )
        self._emit(
            "fleet.replica_added",
            f"replica {rid} registered ({state})",
            replica=rid,
            state=state,
        )
        return replica

    def _on_breaker(self, rid: str, old: str, new: str) -> None:
        if new == "open":
            self.mark(rid, "draining", reason="helper-leg breaker open")
        elif new == "closed":
            with self._lock:
                breaker_drained = (
                    self._states.get(rid) == "draining"
                    and "breaker" in self._reasons.get(rid, "")
                )
            if breaker_drained:
                self.mark(
                    rid, "serving", reason="helper-leg breaker closed"
                )

    # -- transitions ---------------------------------------------------------

    def add_listener(
        self, listener: Callable[[str, str, str, str], None]
    ) -> None:
        """`listener(replica_id, old_state, new_state, reason)` after
        every applied transition; exceptions are swallowed."""
        with self._lock:
            self._listeners.append(listener)

    def mark(self, rid: str, state: str, reason: str = "") -> str:
        """Transition `rid` to `state`; returns the previous state.
        Idempotent transitions (same state) only refresh the reason."""
        if state not in REPLICA_STATES:
            raise ValueError(f"unknown replica state {state!r}")
        with self._lock:
            if rid not in self._replicas:
                raise KeyError(f"unknown replica {rid!r}")
            old = self._states[rid]
            self._states[rid] = state
            self._reasons[rid] = reason
            if old != state:
                self._since[rid] = self._clock()
                self._history.append(
                    {
                        "replica": rid,
                        "from": old,
                        "to": state,
                        "reason": reason,
                        "t_mono": round(self._clock(), 3),
                    }
                )
                if state == "dead":
                    self._deaths += 1
            listeners = list(self._listeners)
        if old != state:
            self._emit(
                "fleet.replica_state",
                f"replica {rid}: {old} -> {state}"
                + (f" ({reason})" if reason else ""),
                severity="warning" if state in ("draining", "dead")
                else "info",
                replica=rid,
                old=old,
                new=state,
                reason=reason,
            )
            for listener in listeners:
                try:
                    listener(rid, old, state, reason)
                except Exception:  # noqa: BLE001 - registry must keep state
                    pass
        return old

    def shed(self, rid: str, reason: str = "shed") -> None:
        """Drain a replica out of the router's candidate set (existing
        work finishes; no new tenants land on it)."""
        with self._lock:
            self._sheds += 1
        self.mark(rid, "draining", reason=reason)

    def readmit(self, rid: str, reason: str = "readmitted") -> None:
        with self._lock:
            self._readmissions += 1
        self.mark(rid, "serving", reason=reason)

    def kill(self, rid: str, reason: str = "killed") -> None:
        self.mark(rid, "dead", reason=reason)

    # -- reading -------------------------------------------------------------

    def get(self, rid: str) -> Replica:
        with self._lock:
            return self._replicas[rid]

    def state(self, rid: str) -> str:
        with self._lock:
            return self._states[rid]

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def alive(self) -> List[Replica]:
        """Every non-dead replica (rotation's participant set)."""
        with self._lock:
            return [
                r
                for rid, r in self._replicas.items()
                if self._states[rid] != "dead"
            ]

    def healthy(self) -> List[Replica]:
        """The router's candidate set: serving or staging state
        (a staging replica still answers from its current generation —
        prestaging N+1 must not read as a fleet-wide outage), and not
        failing its own probe freshness (a pair that cannot prove
        bit-identity must not take new tenants, same rule as its
        /healthz)."""
        with self._lock:
            candidates = [
                r
                for rid, r in self._replicas.items()
                if self._states[rid] in ("serving", "staging")
            ]
        return [r for r in candidates if r.probe_fresh() is not False]

    def generations(self) -> Dict[str, int]:
        return {
            r.replica_id: r.serving_generation() for r in self.replicas()
        }

    def refresh(self) -> Dict[str, str]:
        """Apply probe freshness to health: a serving replica whose
        identity probes went stale drains (same signal its /healthz
        503s on); a drained-for-staleness replica whose probes pass
        again is restored. Returns the post-refresh state map."""
        for replica in self.replicas():
            fresh = replica.probe_fresh()
            if fresh is None:
                continue
            rid = replica.replica_id
            with self._lock:
                state = self._states[rid]
                reason = self._reasons.get(rid, "")
            if state == "serving" and not fresh:
                self.mark(rid, "draining", reason="identity probes stale")
            elif state == "draining" and fresh and "stale" in reason:
                self.mark(rid, "serving", reason="identity probes fresh")
        with self._lock:
            return dict(self._states)

    # -- export --------------------------------------------------------------

    def _emit(self, kind, message, severity="info", **fields):
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        try:
            journal.emit(kind, message, severity=severity, **fields)
        except Exception:  # noqa: BLE001 - journaling never breaks the fleet
            pass

    def export(self) -> dict:
        """The /fleetz view: per-replica state + live readings, state
        counts, transition history."""
        now = self._clock()
        with self._lock:
            rows = {}
            for rid, replica in self._replicas.items():
                row = replica.export()
                row["state"] = self._states[rid]
                row["reason"] = self._reasons.get(rid, "")
                row["since_s"] = round(now - self._since[rid], 3)
                rows[rid] = row
            counts: Dict[str, int] = {s: 0 for s in REPLICA_STATES}
            for state in self._states.values():
                counts[state] += 1
            return {
                "replicas": rows,
                "counts": counts,
                "sheds": self._sheds,
                "readmissions": self._readmissions,
                "deaths": self._deaths,
                "history": [dict(r) for r in self._history],
            }
