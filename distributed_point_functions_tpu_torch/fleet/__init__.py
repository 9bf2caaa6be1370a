"""Replica fleet serving: registry, price-aware routing, quorum rotation.

A port of the JAX package's `fleet/`, over the port's sessions (each
replica's kernels run on its sessions' device).

The top layer of the serving stack: N Leader/Helper pairs composed
into one operable fleet. `registry` tracks replica health states fed
by breaker transitions and probe freshness, `router` is the sticky
price-aware front door with same-generation spillover, and `rotation`
extends the per-pair snapshot handshake to a quorum-gated fleet-wide
flip. Cross-replica bit-identity is proven by
`serving.prober.CrossReplicaProbe` (which stays in serving/ so the
layering keeps fleet -> serving one-way). `telemetry` is the fleet
telemetry plane: per-replica scopes (`ReplicaTelemetry`) and the
`FleetTelemetry` aggregator behind `/fleet-statusz` and
`/fleet-timelinez` (merge rules live in `observability/federation.py`).
"""

from .registry import REPLICA_STATES, Replica, ReplicaSet
from .rotation import FleetRotationCoordinator, QuorumFailed
from .router import FleetRouter
from .telemetry import (
    FleetTelemetry,
    ReplicaTelemetry,
    default_fleet_objectives,
)

__all__ = [
    "REPLICA_STATES",
    "Replica",
    "ReplicaSet",
    "FleetRouter",
    "FleetRotationCoordinator",
    "FleetTelemetry",
    "ReplicaTelemetry",
    "QuorumFailed",
    "default_fleet_objectives",
]
