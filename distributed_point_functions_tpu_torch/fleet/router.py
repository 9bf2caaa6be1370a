"""Price-aware front door: spread tenants across healthy replicas.

A port of the JAX package's `fleet/router.py`. The router is the fleet's single admission point. Placement is
price-driven, not round-robin: each healthy replica advertises its
live `CapacityModel` price card (`price_export` — stamped with the
replica id by the registry) and its admission-queue depth, and the
router scores a replica as

    modeled device-ms per probe batch * (1 + queue_depth)

— the cheapest *idle* replica wins, and a cheap-but-backlogged
replica loses to a slightly pricier idle one. Tenants are sticky: the
first pick pins `tenant -> replica` so a tenant's session state
(wire handshake, generation pin, batcher fairness bucket) stays on
one pair, and the pin survives as long as the replica stays serving.

When the affine replica sheds (`Overloaded` from its admission
queue), the router spills to the other healthy replicas — but ONLY
those currently serving the same generation as the tenant's primary:
a spillover XOR of shares from two generations is well-formed garbage
(the CGKS'95 failure mode snapshot rotation exists to prevent), so a replica
mid-flip is skipped and counted rather than risked. Every attempt
runs with that replica's SnapshotManagers pinned so a fleet rotation
cannot flip a generation out from under the in-flight request.

If the whole candidate set sheds, the router raises one typed fleet
`Overloaded` aggregating the per-replica hints (smallest positive
`retry_after_s`, `reason="fleet"`), so clients see the same
backpressure contract as a single pair.

**Trace stitching.** The router roots one trace per request
(`fleet.request`) before its first attempt; the chosen session's own
`trace_request` then *joins* that trace instead of opening a new one
(nested non-fresh traces reuse the active root — `observability/
tracing.py`), so a primary-shed -> spillover-served request shows up on
`/tracez` as ONE trace carrying a `hops` list of
`(replica, attempt, reason, outcome)` records plus one `fleet.attempt`
span per replica tried. The phase recorder stamps `attrs["phases"]`
onto the same trace, so hops and phase timings ride one record.

**Spillover observability.** With a `metrics=` registry the router
counts `fleet.spillover{from=...,to=...,reason=...}` per spillover
edge, and it watches the spillover rate over a sliding window of
requests: crossing `storm_band` emits one coalesced
`fleet.spillover_storm` journal event (the predictive capacity plane
consumes the series, the operator the event).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, List, Optional

from ..observability import events as events_mod
from ..observability import tracing
from ..serving.batcher import Overloaded
from .registry import Replica, ReplicaSet

__all__ = ["FleetRouter"]


class FleetRouter:
    """Replica-aware request front door over a `ReplicaSet`."""

    def __init__(
        self,
        replica_set: ReplicaSet,
        *,
        price_keys: int = 8,
        journal=None,
        metrics=None,
        storm_band: float = 0.2,
        storm_window: int = 50,
        storm_coalesce_s: float = 5.0,
    ):
        self._set = replica_set
        self._price_keys = int(price_keys)
        self._journal = journal
        self._metrics = metrics
        self._storm_band = float(storm_band)
        self._storm_coalesce_s = float(storm_coalesce_s)
        self._lock = threading.Lock()
        self._affinity: Dict[str, str] = {}
        self._routed: Dict[str, int] = {}
        self._spillovers = 0
        self._generation_skips = 0
        self._fleet_sheds = 0
        self._moves = 0
        self._storms = 0
        # 1 per request that needed at least one spillover, else 0;
        # mean over the window is the live spillover rate.
        self._spill_window: collections.deque = collections.deque(
            maxlen=max(4, int(storm_window))
        )

    # -- placement -----------------------------------------------------------

    def _score(self, replica: Replica) -> float:
        """Price x backlog: modeled device-ms for a probe batch scaled
        by the live admission-queue depth."""
        price = replica.price(self._price_keys)
        return float(price["device_ms"]) * (1.0 + replica.queue_depth())

    def pick(self, tenant: str = "default") -> Replica:
        """The tenant's replica: sticky while the pinned replica stays
        serving, otherwise the cheapest-scored healthy replica (and
        the pin moves there)."""
        healthy = self._set.healthy()
        if not healthy:
            raise Overloaded(
                "no serving replicas in the fleet", reason="fleet"
            )
        by_id = {r.replica_id: r for r in healthy}
        with self._lock:
            pinned = self._affinity.get(tenant)
        if pinned in by_id:
            return by_id[pinned]
        choice = min(healthy, key=self._score)
        with self._lock:
            if pinned is not None:
                self._moves += 1
            self._affinity[tenant] = choice.replica_id
        if pinned is not None:
            self._emit(
                "fleet.affinity_moved",
                f"tenant {tenant!r}: {pinned} -> {choice.replica_id}",
                tenant=tenant,
                old=pinned,
                new=choice.replica_id,
            )
        return choice

    def _candidates(self, tenant: str) -> List[Replica]:
        """Primary first, then same-generation spillover targets.

        Cross-generation spillover is forbidden: shares XORed across
        generations reconstruct garbage, so replicas serving a
        different generation than the tenant's primary are skipped
        (and counted) rather than tried.
        """
        primary = self.pick(tenant)
        generation = primary.serving_generation()
        candidates = [primary]
        for replica in self._set.healthy():
            if replica.replica_id == primary.replica_id:
                continue
            if replica.serving_generation() != generation:
                with self._lock:
                    self._generation_skips += 1
                continue
            candidates.append(replica)
        return candidates

    # -- serving -------------------------------------------------------------

    def handle_request(
        self, request, tenant: str = "default", deadline=None
    ):
        """Serve one request on the tenant's replica, spilling over on
        admission shed; raises a fleet-typed `Overloaded` only when
        every same-generation candidate shed. The whole routing episode
        runs under one trace (see module docstring) whose `hops` attr
        records every replica tried."""
        candidates = self._candidates(tenant)
        sheds: List[Overloaded] = []
        with tracing.trace_request("fleet.request", tenant=tenant) as trace:
            hops = trace.attrs.setdefault("hops", [])
            primary_id = candidates[0].replica_id
            for i, replica in enumerate(candidates):
                rid = replica.replica_id
                reason = (
                    "primary"
                    if i == 0
                    else f"spillover:{sheds[-1].reason or 'shed'}"
                )
                if i > 0:
                    with self._lock:
                        self._spillovers += 1
                    if self._metrics is not None:
                        self._metrics.counter(
                            "fleet.spillover",
                            labels={
                                "from": primary_id,
                                "to": rid,
                                "reason": sheds[-1].reason or "shed",
                            },
                        ).inc()
                hop = {
                    "replica": rid,
                    "attempt": i,
                    "reason": reason,
                    "outcome": "shed",
                }
                hops.append(hop)
                try:
                    # Pin both parties' generations for the attempt: a
                    # fleet rotation must not flip a replica out from
                    # under an admitted request.
                    with tracing.span(
                        "fleet.attempt", replica=rid, attempt=i
                    ), contextlib.ExitStack() as stack:
                        for manager in replica.managers():
                            stack.enter_context(manager.pin())
                        response = replica.leader.handle_request(
                            request, deadline=deadline, tenant=tenant
                        )
                    hop["outcome"] = "served"
                    with self._lock:
                        self._routed[rid] = self._routed.get(rid, 0) + 1
                    self._note_spill_outcome(i > 0)
                    return response
                except Overloaded as exc:
                    sheds.append(exc)
                    continue
            self._note_spill_outcome(True)
            with self._lock:
                self._fleet_sheds += 1
            retry_hints = [
                s.retry_after_s for s in sheds if s.retry_after_s > 0
            ]
            exc = Overloaded(
                f"all {len(candidates)} candidate replicas shed "
                f"(tenant {tenant!r})",
                retry_after_s=min(retry_hints) if retry_hints else 0.0,
                reason="fleet",
            )
            self._emit(
                "fleet.shed",
                f"fleet-wide shed for tenant {tenant!r} "
                f"({len(candidates)} candidates)",
                severity="warning",
                tenant=tenant,
                candidates=len(candidates),
                retry_after_s=exc.retry_after_s,
            )
            raise exc

    def _note_spill_outcome(self, spilled: bool) -> None:
        """Feed the sliding spillover-rate window and emit the coalesced
        storm event when the rate crosses the band (only once the window
        has enough requests to mean anything)."""
        with self._lock:
            self._spill_window.append(1 if spilled else 0)
            window = len(self._spill_window)
            if window < self._spill_window.maxlen // 2:
                return
            rate = sum(self._spill_window) / window
            if rate <= self._storm_band:
                return
            self._storms += 1
        self._emit(
            "fleet.spillover_storm",
            f"spillover rate {rate * 100:.1f}% over last {window} "
            f"requests (band {self._storm_band * 100:.0f}%)",
            severity="warning",
            coalesce_key="fleet.spillover_storm",
            coalesce_s=self._storm_coalesce_s,
            rate_pct=round(rate * 100, 2),
            window=window,
        )

    def spillover_rate_pct(self) -> float:
        """Live spillover rate (percent of recent requests that needed
        at least one spillover) — the fleet SLO ceiling reads this."""
        with self._lock:
            if not self._spill_window:
                return 0.0
            return round(
                100.0 * sum(self._spill_window) / len(self._spill_window), 3
            )

    # -- reading -------------------------------------------------------------

    def affinity(self, tenant: str) -> Optional[str]:
        with self._lock:
            return self._affinity.get(tenant)

    def forget(self, tenant: str) -> None:
        with self._lock:
            self._affinity.pop(tenant, None)

    def _emit(self, kind, message, severity="info", **fields):
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        try:
            journal.emit(kind, message, severity=severity, **fields)
        except Exception:  # noqa: BLE001 - journaling never breaks routing
            pass

    def export(self) -> dict:
        rate = self.spillover_rate_pct()
        with self._lock:
            return {
                "tenants": len(self._affinity),
                "affinity": dict(self._affinity),
                "routed": dict(self._routed),
                "spillovers": self._spillovers,
                "generation_skips": self._generation_skips,
                "fleet_sheds": self._fleet_sheds,
                "affinity_moves": self._moves,
                "spillover_rate_pct": rate,
                "spillover_storms": self._storms,
                "storm_band_pct": round(self._storm_band * 100, 1),
            }
