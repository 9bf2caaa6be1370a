"""Fleet-wide quorum rotation: stage everywhere, flip on quorum ack.

A port of the JAX package's `fleet/rotation.py`. The serving runtime's
`RotationCoordinator` rotates ONE pair atomically (stage both
parties, flip Helper-first/Leader-last). A fleet multiplies the
failure modes: a replica can die mid-stage, flip late, or come back
on the wrong generation — and a client whose two shares come from
different generations reconstructs well-formed garbage. The fleet
coordinator keeps the per-pair handshake exactly as the pair's
coordinator does and adds a two-phase commit across replicas:

  Phase 1 — stage generation N+1 on every non-dead replica (each pair
  stages Leader then Helper; the per-replica chaos site
  ``fleet.stage.<replica_id>`` fires between marking the replica
  `staging` and staging its managers, mirroring ``snapshot.stage``).
  A replica that faults here has its staged buffers aborted and
  becomes a laggard candidate.

  Quorum gate — if fewer than `quorum` replicas staged cleanly, the
  rotation aborts EVERYWHERE: every staged buffer is dropped, every
  state restored, and `QuorumFailed` raised. Generation N keeps
  serving on the whole fleet; nothing flipped.

  Phase 2 — flip every acked replica (Helper first, Leader last,
  per-pair staleness noted into its manager). A flip fault aborts
  that pair and demotes it to laggard; the quorum already committed,
  so the fleet moves to N+1 regardless.

  Phase 3 — each laggard is SHED from the router's candidate set
  (`draining`: no new tenants can land on a mixed-generation pair),
  then re-staged and flipped party by party — skipping any party
  already at the target generation, so a replica that flipped its
  Helper but faulted on its Leader converges instead of double-
  flipping — and readmitted on success, or marked `dead` on failure.

Mixed generations never reach one tenant: the router only spills
within the primary's generation, per-session generation pinning rides
the wire's generation handshake, and laggards are out of the candidate
set until they converge.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..observability import events as events_mod
from ..robustness import failpoints
from .registry import Replica, ReplicaSet

__all__ = ["QuorumFailed", "FleetRotationCoordinator"]


class QuorumFailed(RuntimeError):
    """Raised when fewer replicas staged the new generation than the
    configured quorum; the rotation was aborted fleet-wide and the old
    generation keeps serving everywhere."""

    def __init__(self, to_generation, acked, failed, quorum):
        self.to_generation = to_generation
        self.acked = list(acked)
        self.failed = dict(failed)
        self.quorum = quorum
        super().__init__(
            f"quorum failed for generation {to_generation}: "
            f"{len(self.acked)}/{quorum} staged "
            f"(failed: {sorted(self.failed)})"
        )


class FleetRotationCoordinator:
    """Quorum-gated fleet rotation over a `ReplicaSet` (module
    docstring has the phase machine)."""

    def __init__(
        self,
        replica_set: ReplicaSet,
        *,
        quorum: Optional[int] = None,
        clock=time.monotonic,
        journal=None,
    ):
        self._set = replica_set
        self._quorum = quorum
        self._clock = clock
        self._journal = journal
        self._telemetry = None
        self._rotations = 0
        self._quorum_failures = 0
        self._last_report: Optional[dict] = None

    def set_telemetry(self, telemetry):
        """Attach a `FleetTelemetry` (duck-typed: `.sample()`) to be
        resampled right after each rotation, so
        `fleet.rotation_staleness_ms` reflects the flip immediately
        instead of at the next sampler tick."""
        self._telemetry = telemetry
        return telemetry

    # -- helpers -------------------------------------------------------------

    def _resolve_dbs(self, databases, replica: Replica) -> Tuple:
        """`databases` is either a mapping `replica_id -> (leader_db,
        helper_db)` or a callable `replica -> (leader_db, helper_db)`
        (helper_db None for a plain replica)."""
        if callable(databases):
            pair = databases(replica)
        else:
            pair = databases[replica.replica_id]
        leader_db, helper_db = pair
        if replica.helper_snapshots is not None and helper_db is None:
            raise ValueError(
                f"replica {replica.replica_id!r} has a helper manager "
                "but no helper database (the parties stage distinct "
                "database objects)"
            )
        return leader_db, helper_db

    @staticmethod
    def _abort_pair(replica: Replica, reason: str) -> None:
        for manager in replica.managers():
            manager.abort(reason)

    def _stage_pair(self, replica: Replica, leader_db, helper_db) -> dict:
        staged = {"leader_staged_bytes": replica.snapshots.stage(leader_db)}
        if replica.helper_snapshots is not None:
            staged["helper_staged_bytes"] = replica.helper_snapshots.stage(
                helper_db
            )
        return staged

    def _flip_pair(
        self, replica: Replica, timeout: float
    ) -> float:
        """Helper-first/Leader-last flip (the pair's ordering) returning
        the pair's measured staleness window in ms."""
        t_helper = None
        if replica.helper_snapshots is not None:
            replica.helper_snapshots.flip(timeout=timeout)
            t_helper = self._clock()
        replica.snapshots.flip(timeout=timeout)
        if t_helper is None:
            return 0.0
        staleness_ms = max(0.0, (self._clock() - t_helper) * 1e3)
        replica.snapshots.note_staleness(staleness_ms)
        return round(staleness_ms, 3)

    def _converge_laggard(
        self, replica: Replica, leader_db, helper_db,
        to_generation: int, timeout: float,
    ) -> None:
        """Bring one shed laggard to the target generation, party by
        party. A party already AT the target (e.g. the Helper flipped
        before the Leader faulted) is skipped — `SnapshotManager.flip`
        at the current generation would return a stale record and
        leave a staged candidate armed."""
        pairs = [(replica.snapshots, leader_db)]
        if replica.helper_snapshots is not None:
            pairs.append((replica.helper_snapshots, helper_db))
        # Helper converges first, same ordering rationale as the flip.
        for manager, db in reversed(pairs):
            if manager.serving_generation() == to_generation:
                continue
            manager.abort(f"laggard re-stage to {to_generation}")
            manager.stage(db)
            manager.flip(timeout=timeout)

    def _emit(self, kind, message, severity="info", **fields):
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        try:
            journal.emit(kind, message, severity=severity, **fields)
        except Exception:  # noqa: BLE001 - journaling never breaks rotation
            pass

    # -- the rotation --------------------------------------------------------

    def rotate(self, databases, timeout: float = 10.0) -> dict:
        """Run one fleet rotation (module docstring has the phases).
        Returns the report dict; raises `QuorumFailed` when staging
        fell short of quorum (in which case nothing flipped anywhere).
        """
        participants = [
            r for r in self._set.alive() if r.snapshots is not None
        ]
        if not participants:
            raise ValueError("no rotatable replicas (none have snapshots)")
        quorum = (
            self._quorum
            if self._quorum is not None
            else len(participants) // 2 + 1
        )
        if not 1 <= quorum <= len(participants):
            raise ValueError(
                f"quorum {quorum} out of range for "
                f"{len(participants)} participants"
            )
        dbs: Dict[str, Tuple] = {
            r.replica_id: self._resolve_dbs(databases, r)
            for r in participants
        }
        to_generation = dbs[participants[0].replica_id][0].generation
        per_replica: Dict[str, dict] = {}

        # Phase 1: stage everywhere.
        acked: List[Replica] = []
        failed: Dict[str, str] = {}
        for replica in participants:
            rid = replica.replica_id
            prev_state = self._set.state(rid)
            self._set.mark(rid, "staging", reason=f"stage {to_generation}")
            try:
                failpoints.fire(f"fleet.stage.{rid}")
                per_replica[rid] = self._stage_pair(replica, *dbs[rid])
                acked.append(replica)
            except Exception as e:  # noqa: BLE001 - per-replica fault domain
                self._abort_pair(replica, f"stage {to_generation}: {e}")
                failed[rid] = str(e)
                per_replica[rid] = {"stage_error": str(e)}
                self._set.mark(rid, prev_state, reason=f"stage failed: {e}")

        # Quorum gate: short of quorum, nothing flips anywhere.
        if len(acked) < quorum:
            for replica in acked:
                self._abort_pair(
                    replica,
                    f"quorum failed for generation {to_generation}",
                )
                self._set.mark(
                    replica.replica_id, "serving",
                    reason="rotation aborted (quorum failed)",
                )
            self._quorum_failures += 1
            self._emit(
                "fleet.quorum_failed",
                f"rotation to {to_generation} aborted: "
                f"{len(acked)}/{quorum} replicas staged",
                severity="error",
                to_generation=to_generation,
                acked=[r.replica_id for r in acked],
                failed=sorted(failed),
                quorum=quorum,
            )
            raise QuorumFailed(to_generation, (
                r.replica_id for r in acked), failed, quorum)

        # Phase 2: flip the acked set; flip faults demote to laggard.
        flipped: List[str] = []
        laggards: Dict[str, str] = dict(failed)
        worst_staleness = 0.0
        for replica in acked:
            rid = replica.replica_id
            try:
                staleness_ms = self._flip_pair(replica, timeout)
                per_replica[rid]["staleness_ms"] = staleness_ms
                worst_staleness = max(worst_staleness, staleness_ms)
                flipped.append(rid)
                self._set.mark(
                    rid, "serving", reason=f"serving {to_generation}"
                )
            except Exception as e:  # noqa: BLE001 - per-replica fault domain
                self._abort_pair(replica, f"flip {to_generation}: {e}")
                per_replica[rid]["flip_error"] = str(e)
                laggards[rid] = str(e)

        # Phase 3: shed each laggard, converge it, readmit or bury it.
        laggard_outcomes: Dict[str, str] = {}
        for rid, why in laggards.items():
            replica = self._set.get(rid)
            self._set.shed(
                rid, reason=f"rotation laggard at {to_generation}: {why}"
            )
            try:
                self._converge_laggard(
                    replica, *dbs[rid], to_generation, timeout
                )
                self._set.readmit(
                    rid, reason=f"laggard converged to {to_generation}"
                )
                laggard_outcomes[rid] = "recovered"
            except Exception as e:  # noqa: BLE001 - per-replica fault domain
                self._abort_pair(replica, f"laggard converge: {e}")
                self._set.kill(
                    rid, reason=f"laggard unrecoverable: {e}"
                )
                laggard_outcomes[rid] = "dead"

        self._rotations += 1
        report = {
            "to_generation": to_generation,
            "quorum": quorum,
            "participants": [r.replica_id for r in participants],
            "acked": [r.replica_id for r in acked],
            "flipped": flipped,
            "laggards": laggard_outcomes,
            "staleness_ms": round(worst_staleness, 3),
            "per_replica": per_replica,
        }
        self._last_report = report
        self._emit(
            "fleet.rotation",
            f"fleet rotated to generation {to_generation}: "
            f"{len(flipped)}/{len(participants)} flipped in phase 2, "
            f"laggards {laggard_outcomes or '{}'}",
            severity="warning" if laggard_outcomes else "info",
            **{k: v for k, v in report.items() if k != "per_replica"},
        )
        if self._telemetry is not None:
            try:
                self._telemetry.sample()
            except Exception:  # noqa: BLE001 - telemetry never breaks rotation
                pass
        return report

    def export(self) -> dict:
        return {
            "rotations": self._rotations,
            "quorum_failures": self._quorum_failures,
            "last_report": self._last_report,
        }
