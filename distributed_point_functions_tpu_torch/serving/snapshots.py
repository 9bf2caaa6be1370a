"""Versioned database snapshots: crash-safe rotation under live traffic.

The port of the JAX package's `serving/snapshots.py`, on the port's
`DenseDpfPirDatabase`: `stage` runs `prestage`, which for a
`Builder.build_from(prev)` delta copies N's staging on the card and
scatters in only the updated rows (`last_prestage_stats["mode"] ==
"delta"`), and the drain frees N's device buffers once its last batch
has read its result back. A server with `validate_snapshot` (the
sparse one) decides what may be staged; its refusal is a
`SnapshotMismatch`. A flip's drain wait is a `snapshot_flip` bubble of
the process-wide utilization tracker. The prober pins a manager around
each probe (`pin()`) and re-keys its goldens on each flip
(`add_flip_listener`); `RotationCoordinator.suggest_window` reads a
forecast's trough window. Not carried: the debug-bundle capture on a
refused cross-generation answer.

Every session used to stage one immutable `DenseDpfPirDatabase` at
construction and serve it forever. A directory changes continuously,
and in the CGKS two-server model the dangerous failure is *silent*: if
the Leader's share evaluates against generation N while the Helper
answers from N+1, both shares are perfectly well-formed and their XOR
is garbage. No latency metric flags it; only a prober's bit-identity
check would, after the fact. Rotation therefore has to preserve one
invariant end to end:

    a response is either computed entirely against one generation,
    or it is a typed refusal — never a cross-generation XOR.

`SnapshotManager` owns the generation lifecycle on one party:

* **stage(db)** — generation N+1 (usually
  `DenseDpfPirDatabase.Builder.build_from(prev)`) is staged on the
  device beside N via the server's `prestage_database` while N keeps
  serving. Failpoint site: `snapshot.stage`.
* **flip()** — arms a pending flip and applies it at a *batch
  boundary*: the `DynamicBatcher` worker calls `begin_batch()` before
  every evaluation (applying the pending flip first) and
  `end_batch(gen)` after its fan-out, so a batch never evaluates
  half-and-half and in-flight buckets drain against the generation
  they bound. Failpoint site: `snapshot.flip`.
* **drain-then-free** — the old generation's device stagings are
  dropped (`release_stagings()`, journaled as `snapshot.drained`)
  only after its last in-flight batch retires, so a response being
  computed against N never loses its buffers mid-evaluation.

`RotationCoordinator` drives the two-party handshake: stage on both
parties, then flip the **Helper first and the Leader last**
(failpoint site `snapshot.helper_ack` between). During the bounded
window in between, the Leader's generation check (`serving/
service.py`) refuses the Helper's v3 echo with a typed
`SnapshotMismatch` and retries — the retry lands after the Leader's
own flip and converges. The window is measured: `staleness_ms` on the
flip-history record is the Helper->Leader flip gap. Any staging or
flip fault aborts both parties (`snapshot.abort`), leaving generation
N serving untouched — rotation is crash-safe because the flip is the
single commit point and everything before it is droppable staging.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, List, Optional

from ..observability import events as events_mod
from ..observability.utilization import default_utilization_tracker
from ..robustness import failpoints

__all__ = [
    "SnapshotMismatch",
    "SnapshotManager",
    "RotationCoordinator",
]


class SnapshotMismatch(RuntimeError):
    """The two parties answered one query from different database
    generations. The shares must not be combined (their XOR is
    well-formed garbage); the Leader retries the whole request
    instead — see `ServingConfig.snapshot_retries`."""

    def __init__(
        self,
        leader_generation: Optional[int],
        helper_generation: Optional[int],
        message: str = "",
    ):
        super().__init__(
            message
            or (
                "snapshot generation mismatch: leader evaluated against "
                f"generation {leader_generation}, helper answered from "
                f"{helper_generation}"
            )
        )
        self.leader_generation = leader_generation
        self.helper_generation = helper_generation


class SnapshotManager:
    """One party's generation lifecycle (see module docstring).

    `session` is a serving `_Session` (duck-typed: `.server`,
    `.batcher`, `.metrics`, `.attach_snapshots`); construction wires
    the manager in as the batcher's generation source, so flips land
    only at batch boundaries from then on. `journal` defaults to the
    process journal; `clock` is injectable for deterministic staleness
    tests.
    """

    def __init__(
        self,
        session,
        *,
        journal=None,
        clock=time.monotonic,
        name: str = "snapshots",
        history: int = 32,
    ):
        self._session = session
        self._server = session.server
        self._journal = journal
        self._clock = clock
        self._name = name
        m = session.metrics
        self._c_flips = m.counter(f"{name}.flips")
        self._c_aborts = m.counter(f"{name}.aborts")
        self._c_mismatches = m.counter(f"{name}.mismatches")
        self._c_drained = m.counter(f"{name}.generations_drained")
        self._c_freed_bytes = m.counter(f"{name}.bytes_freed")
        self._g_serving = m.gauge(f"{name}.serving_generation")
        self._g_staging = m.gauge(f"{name}.staging_generation")
        self._cond = threading.Condition()
        self._staging = None
        # Most recent prestage accounting (database.last_prestage_stats
        # from the last stage() call): mode full/delta, bytes staged vs
        # the full image, bytes saved.
        self._last_stage: Optional[dict] = None
        self._pending_flip = False
        # generation -> in-flight batch count (bound at begin_batch).
        self._inflight: dict = {}
        # Retired generations still owed a drain: generation -> db.
        self._retired: dict = {}
        self._pins = 0
        self._flip_listeners: List[Callable] = []
        self._history: collections.deque = collections.deque(
            maxlen=max(1, history)
        )
        # One record a drained generation: {generation, buffers_freed,
        # bytes_freed}.
        self._drains: collections.deque = collections.deque(
            maxlen=max(1, history)
        )
        self._g_serving.set(float(self.serving_generation()))
        self._g_staging.set(-1.0)
        session.attach_snapshots(self)

    # -- reading ------------------------------------------------------------

    def serving_generation(self) -> int:
        return self._server.database.generation

    def staging_generation(self) -> Optional[int]:
        with self._cond:
            return (
                self._staging.generation
                if self._staging is not None else None
            )

    def set_journal(self, journal):
        """Point rotation events at a (replica-scoped) journal; None
        restores the process journal. A fleet's telemetry plane calls
        this when it adopts the replica. Returns `journal`."""
        self._journal = journal
        return journal

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

    def add_flip_listener(self, listener: Callable[[dict], None]) -> None:
        """Register `listener(flip_record)`, called after every applied
        flip outside the manager lock (the prober re-keys its golden
        pairs here). Exceptions are swallowed."""
        with self._cond:
            self._flip_listeners.append(listener)

    # -- staging ------------------------------------------------------------

    def stage(self, database) -> int:
        """Stage generation N+1 on the device beside N while N keeps
        serving; returns the bytes transferred (0 when the buffer was
        already resident). Geometry must match the serving database —
        a mismatch fails here, before any flip is armed. Replacing an
        already-staged (never-flipped) candidate drops its buffers."""
        cur = self._server.database
        validate = getattr(self._server, "validate_snapshot", None)
        if validate is not None:
            # A server that owns its swap precondition (the sparse one:
            # cuckoo geometry and row layout) refuses a mis-rotated
            # snapshot as the typed rotation fault.
            try:
                validate(database)
            except ValueError as e:
                self._c_mismatches.inc()
                raise SnapshotMismatch(
                    cur.generation, database.generation,
                    message=f"staged generation rejected: {e}",
                ) from e
        elif database.size != cur.size:
            raise ValueError(
                f"staged generation size {database.size} != serving "
                f"{cur.size}"
            )
        elif database.max_value_size != cur.max_value_size:
            raise ValueError(
                "staged generation max_value_size "
                f"{database.max_value_size} != serving "
                f"{cur.max_value_size}"
            )
        failpoints.fire("snapshot.stage")
        # Stage in the layout the server serves.
        staged_bytes = self._server.prestage_database(database)
        # What the database moved against its full image
        # (`bytes_saved` is the delta's win, 0 for a full staging).
        stage_stats = database.last_prestage_stats
        replaced = None
        with self._cond:
            if self._staging is not None and self._staging is not database:
                replaced = self._staging
            self._staging = database
            self._g_staging.set(float(database.generation))
            if stage_stats is not None:
                self._last_stage = dict(stage_stats)
        if replaced is not None:
            replaced.release_stagings()
        return staged_bytes

    # -- the batch-boundary contract (DynamicBatcher generation source) -----

    def begin_batch(self) -> int:
        """Called by the batcher worker before every evaluation: apply
        a pending flip first (unless pinned readers hold it off), then
        bind the batch to the now-serving generation."""
        fired = None
        with self._cond:
            if self._pending_flip and self._pins == 0:
                fired = self._apply_flip_locked()
            gen = self._server.database.generation
            self._inflight[gen] = self._inflight.get(gen, 0) + 1
        if fired is not None:
            self._after_flip(fired)
        return gen

    def end_batch(self, generation: int) -> None:
        """The batch bound at `begin_batch` has fully retired: its
        generation's drain counter steps down, and a retired (flipped-
        away) generation whose count reaches zero frees its stagings."""
        to_free = None
        with self._cond:
            n = self._inflight.get(generation, 0) - 1
            if n > 0:
                self._inflight[generation] = n
            else:
                self._inflight.pop(generation, None)
                to_free = self._retired.pop(generation, None)
            self._cond.notify_all()
        if to_free is not None:
            self._free_retired(to_free)

    def _free_retired(self, database) -> None:
        nbytes = database.staged_bytes()
        dropped = database.release_stagings()
        self._c_drained.inc()
        self._c_freed_bytes.inc(nbytes)
        with self._cond:
            self._drains.append({
                "generation": database.generation,
                "buffers_freed": dropped,
                "bytes_freed": nbytes,
            })
        self._emit(
            "snapshot.drained",
            f"generation {database.generation} drained; "
            f"{dropped} staged buffer(s), {nbytes} bytes freed",
            generation=database.generation,
            buffers_freed=dropped,
            bytes_freed=nbytes,
        )

    @contextlib.contextmanager
    def pin(self):
        """Bracket an unbatched multi-step read (one prober probe pair):
        a pending flip is not applied while any pin is held, so
        everything inside sees one generation. Yields that generation."""
        with self._cond:
            self._pins += 1
            gen = self._server.database.generation
        try:
            yield gen
        finally:
            with self._cond:
                self._pins -= 1
                self._cond.notify_all()

    # -- flipping -----------------------------------------------------------

    def flip(self, timeout: float = 10.0) -> dict:
        """Commit the staged generation: applied immediately when the
        party is idle, otherwise armed and applied by the batcher
        worker at the next batch boundary (this call waits for it).
        Returns the flip-history record. Raises `TimeoutError` (after
        disarming) if in-flight work or pins never drain — the staged
        generation stays staged and N keeps serving."""
        failpoints.fire("snapshot.flip")
        fired = None
        waited_s = 0.0
        with self._cond:
            if self._staging is None:
                raise RuntimeError("no staged generation to flip to")
            target = self._staging.generation
            self._pending_flip = True
            deadline = time.monotonic() + max(0.0, timeout)
            while self._server.database.generation != target:
                if self._pending_flip and self._pins == 0 and not any(
                        self._inflight.values()):
                    fired = self._apply_flip_locked()
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._pending_flip = False
                    raise TimeoutError(
                        f"flip to generation {target} timed out after "
                        f"{timeout:.1f}s (pins={self._pins}, inflight="
                        f"{sum(self._inflight.values())})"
                    )
                t_wait = time.monotonic()
                self._cond.wait(remaining)
                waited_s += time.monotonic() - t_wait
            record = self._history[-1]
            record["flip_wait_ms"] = round(waited_s * 1e3, 3)
        # The flip's drain wait (in-flight batches) is a typed bubble:
        # the rotation held work back.
        default_utilization_tracker().record_idle(
            "snapshot_flip", waited_s, thread="rotation")
        if fired is not None:
            self._after_flip(fired)
        return dict(record)

    def _apply_flip_locked(self) -> dict:
        """Swap the staged generation in at a proven batch boundary
        (caller holds the lock). The old
        generation retires: freed now if nothing is in flight against
        it, else parked until `end_batch` drains it."""
        new = self._staging
        old = self._server.swap_database(new)
        self._staging = None
        self._pending_flip = False
        record = {
            "from_generation": old.generation,
            "to_generation": new.generation,
            "t_mono": round(self._clock(), 6),
            "staleness_ms": None,
            "inflight_old": self._inflight.get(old.generation, 0),
        }
        self._retired[old.generation] = old
        record["old_freed"] = (
            "deferred"
            if self._inflight.get(old.generation, 0) > 0
            else "immediate"
        )
        self._history.append(record)
        self._c_flips.inc()
        self._g_serving.set(float(new.generation))
        self._g_staging.set(-1.0)
        self._cond.notify_all()
        return record

    def _after_flip(self, record: dict) -> None:
        """Post-commit work that runs outside the manager lock (a
        listener may submit to the batcher, whose worker needs
        `begin_batch`): freeing an idle old generation, the journal
        line, and the flip listeners."""
        if record.get("old_freed") == "immediate":
            with self._cond:
                db = self._retired.pop(record["from_generation"], None)
            if db is not None:
                self._free_retired(db)
        self._emit(
            "snapshot.flip",
            f"generation {record['from_generation']} -> "
            f"{record['to_generation']} "
            f"(old stagings {record['old_freed']})",
            from_generation=record["from_generation"],
            to_generation=record["to_generation"],
        )
        with self._cond:
            listeners = list(self._flip_listeners)
        for listener in listeners:
            try:
                listener(dict(record))
            except Exception:  # noqa: BLE001 - listeners must not break flips
                pass

    def note_staleness(self, staleness_ms: float) -> None:
        """Stamp the Helper->Leader flip gap (measured by the
        coordinator) onto the most recent flip record."""
        with self._cond:
            if self._history:
                self._history[-1]["staleness_ms"] = round(
                    float(staleness_ms), 3
                )

    # -- failure paths ------------------------------------------------------

    def abort(self, reason: str) -> None:
        """Drop the staged (never-flipped) candidate and disarm any
        pending flip; generation N keeps serving untouched. Idempotent
        — aborting with nothing staged only journals."""
        with self._cond:
            db = self._staging
            self._staging = None
            self._pending_flip = False
            self._g_staging.set(-1.0)
            self._cond.notify_all()
        if db is not None:
            try:
                db.release_stagings()
            except Exception:  # noqa: BLE001 - abort must not raise
                pass
        self._c_aborts.inc()
        self._emit(
            "snapshot.abort",
            f"rotation aborted: {reason}",
            severity="warning",
            reason=str(reason)[:256],
        )

    def record_mismatch(
        self,
        leader_generation: Optional[int],
        helper_generation: Optional[int],
        trace_id: Optional[str] = None,
    ) -> None:
        """A cross-generation answer was refused: count it and journal
        it."""
        self._c_mismatches.inc()
        self._emit(
            "snapshot.mismatch",
            f"refused cross-generation answer: leader={leader_generation} "
            f"helper={helper_generation}",
            severity="error",
            leader_generation=leader_generation,
            helper_generation=helper_generation,
            coalesce_key=(
                f"snapshot.mismatch:{leader_generation}:{helper_generation}"
            ),
            coalesce_s=1.0,
        )

    def note_unchecked(self, peer_version: int) -> None:
        """A pre-v3 peer answered with no generation echo while
        rotation machinery is live: checking is disabled for that
        peer, journaled (coalesced) so the gap is visible, and the
        answer is still only combined when this party's own
        generation is current — never silently cross-generation."""
        self._emit(
            "snapshot.check_disabled",
            f"peer speaks wire v{peer_version}: generation checking "
            "disabled for this peer",
            severity="warning",
            peer_version=int(peer_version),
            coalesce_key=f"snapshot.check_disabled:{peer_version}",
            coalesce_s=5.0,
        )

    # -- export -------------------------------------------------------------

    def export(self) -> dict:
        with self._cond:
            return {
                "serving_generation": self._server.database.generation,
                "staging_generation": (
                    self._staging.generation
                    if self._staging is not None else None
                ),
                "pending_flip": self._pending_flip,
                "pins": self._pins,
                "inflight": {
                    str(g): n for g, n in sorted(self._inflight.items())
                },
                "retired_awaiting_drain": sorted(self._retired),
                "flips": self._c_flips.value,
                "aborts": self._c_aborts.value,
                "mismatches": self._c_mismatches.value,
                "last_stage": (
                    dict(self._last_stage)
                    if self._last_stage is not None else None
                ),
                "history": [dict(r) for r in self._history],
                "drains": [dict(r) for r in self._drains],
            }


class RotationCoordinator:
    """Two-party prepare->flip handshake (see module docstring).

    `leader` and `helper` are `SnapshotManager`s (helper None for a
    single-party/plain deployment). The flip order is deliberate —
    **Helper first, Leader last** — so the only cross-generation
    window is one the Leader's generation check turns into typed
    retries: a Leader answering from N while the Helper is already on
    N+1 refuses the echo and retries; the reverse order would need the
    Helper to police the Leader, which the wire does not support.
    """

    def __init__(self, leader: SnapshotManager, helper=None, clock=time.monotonic):
        self._leader = leader
        self._helper = helper
        self._clock = clock
        self._window_source = None

    def set_window_source(self, source) -> None:
        """Attach a forecast trough finder: a `window_s -> dict` callable
        (in practice `observability.forecast.Forecaster.window_source(
        series)`) whose dict carries at least `start_offset_s`. None
        detaches."""
        self._window_source = source

    def suggest_window(self, window_s: float = 30.0) -> dict:
        """When should the next rotation prestage start? With a window
        source attached, the forecast's lowest-load window inside its
        horizon; without one, or when the source raises, now. Advisory
        only: `rotate()` never waits on it."""
        suggestion = {
            "window_s": float(window_s),
            "start_offset_s": 0.0,
            "source": "none",
        }
        if self._window_source is None:
            return suggestion
        try:
            trough = self._window_source(window_s) or {}
        except Exception:  # noqa: BLE001 - advice must not break rotation
            suggestion["source"] = "error"
            return suggestion
        suggestion.update(trough)
        suggestion["window_s"] = float(window_s)
        suggestion["source"] = "forecast"
        return suggestion

    def rotate(
        self,
        leader_db,
        helper_db=None,
        timeout: float = 10.0,
    ) -> dict:
        """Stage both parties, then flip Helper-first/Leader-last.
        Returns a report with the measured `staleness_ms` window. Any
        fault aborts both parties and re-raises: generation N keeps
        serving and the staged buffers are dropped."""
        if self._helper is not None and helper_db is None:
            raise ValueError(
                "helper_db is required when a helper manager is attached "
                "(the parties stage distinct database objects)"
            )
        report = {
            "to_generation": leader_db.generation,
            "staleness_ms": 0.0,
        }
        try:
            report["leader_staged_bytes"] = self._leader.stage(leader_db)
            if self._helper is not None:
                report["helper_staged_bytes"] = self._helper.stage(
                    helper_db
                )
            # Chaos site: the prepare->flip ack between staging both
            # parties and committing either — a fault here must leave
            # generation N serving on both.
            failpoints.fire("snapshot.helper_ack")
            t_helper = None
            if self._helper is not None:
                self._helper.flip(timeout=timeout)
                t_helper = self._clock()
            self._leader.flip(timeout=timeout)
            if t_helper is not None:
                staleness_ms = max(0.0, (self._clock() - t_helper) * 1e3)
                report["staleness_ms"] = round(staleness_ms, 3)
                self._leader.note_staleness(staleness_ms)
        except Exception as e:
            self._leader.abort(f"rotation to {leader_db.generation}: {e}")
            if self._helper is not None:
                self._helper.abort(
                    f"rotation to {leader_db.generation}: {e}"
                )
            raise
        return report
