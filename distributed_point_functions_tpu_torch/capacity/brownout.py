"""Brownout ladder: escalating, auto-reverting load-shed steps driven
by SLO burn, copied from the JAX package's `capacity/brownout.py`.

When the SLO tracker (`observability/slo.py`) reports a
sustained breach, serving should degrade *gracefully* — shed the least
valuable work first, keep the most valuable work correct — and undo
every step once the burn clears. The ladder's four steps, in
escalation order:

1. ``shed_low_priority`` — admission floor rises to priority 1:
   best-effort tenants (priority 0) are shed with `RetryAfter`.
2. ``cap_batches`` — the batcher's effective max batch size is capped,
   trading peak throughput for shorter queue drains (lower tail
   latency for what is still admitted).
3. ``force_cheap_tier`` — the PIR server's tier floor
   (`pir/server.py:set_tier_floor`) is pushed toward the streaming or
   chunked tier, shrinking the device memory a batch holds so that
   concurrent sweeps and serving stop fighting for it.
4. ``critical_only`` — admission floor rises to priority 2: only
   tenants marked critical are admitted.

The controller knows *when* to step, never *what* the steps touch:
each step's engage/revert callbacks are registered by the serving
layer (`attach_brownout` in `serving/service.py`) so this package
keeps its place below serving in the layer DAG. Transitions are
hysteretic (engage after `engage_after_s` of breach, escalate every
`escalate_after_s` while still breaching, revert one step per
`revert_after_s` of sustained health), counted in metrics, appended to
an exported transition log (`/statusz`), and attached to the active
trace when one exists.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..observability import events as events_mod
from ..observability import tracing

BROWNOUT_STEPS: Tuple[str, ...] = (
    "shed_low_priority",
    "cap_batches",
    "force_cheap_tier",
    "critical_only",
)

_TRANSITION_LOG_LIMIT = 64


class BrownoutController:
    """See module docstring. Drive it either by calling `evaluate()`
    from an existing maintenance loop or via `start(period_s)`."""

    def __init__(
        self,
        slo=None,
        *,
        signal: Optional[Callable[[], bool]] = None,
        engage_after_s: float = 0.0,
        escalate_after_s: float = 5.0,
        revert_after_s: float = 10.0,
        metrics=None,
        name: str = "brownout",
        clock: Callable[[], float] = time.monotonic,
    ):
        """`slo` is any object with `breaches() -> list` (the
        `SloTracker`); `signal` is an explicit breach predicate that
        overrides it (tests, synthetic drills). One of the two must be
        provided before `evaluate()` is useful."""
        self._slo = slo
        self._signal = signal
        self._engage_after_s = max(0.0, engage_after_s)
        self._escalate_after_s = max(0.0, escalate_after_s)
        self._revert_after_s = max(0.0, revert_after_s)
        self._clock = clock
        self._name = name
        self._lock = threading.Lock()
        self._level = 0
        self._breach_since: Optional[float] = None
        self._healthy_since: Optional[float] = None
        self._last_transition: Optional[float] = None
        self._actions: Dict[str, Tuple[Callable, Callable]] = {}
        self._transitions: List[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.metrics = metrics
        if metrics is not None:
            self._g_level = metrics.gauge(f"{name}.level")
            self._c_engaged = {
                step: metrics.counter(f"{name}.engaged{{step={step}}}")
                for step in BROWNOUT_STEPS
            }
            self._c_reverted = {
                step: metrics.counter(f"{name}.reverted{{step={step}}}")
                for step in BROWNOUT_STEPS
            }
            self._c_action_errors = metrics.counter(f"{name}.action_errors")

    # -- wiring --------------------------------------------------------------

    def add_step_action(
        self,
        step: str,
        engage: Callable[[], None],
        revert: Callable[[], None],
    ) -> None:
        """Register what engaging/reverting `step` does. Steps with no
        registered action still transition (and are still listed), they
        just have no effect — so a deployment may wire any subset."""
        if step not in BROWNOUT_STEPS:
            raise ValueError(
                f"unknown brownout step {step!r}; steps are"
                f" {BROWNOUT_STEPS}"
            )
        with self._lock:
            self._actions[step] = (engage, revert)

    # -- state machine -------------------------------------------------------

    def _breaching(self) -> bool:
        if self._signal is not None:
            return bool(self._signal())
        if self._slo is not None:
            try:
                # Fresh grading each control step (breaches() without
                # evaluate reuses the last scrape, which may be stale
                # when nothing else polls the tracker).
                return bool(self._slo.breaches(evaluate=True))
            except TypeError:
                try:
                    return bool(self._slo.breaches())
                except Exception:  # noqa: BLE001
                    return False
            except Exception:  # noqa: BLE001 - burn probe must not kill us
                return False
        return False

    def evaluate(self, now: Optional[float] = None) -> int:
        """One control step: observe burn, engage/escalate/revert at
        most one ladder step. Returns the post-step level (0..4)."""
        breaching = self._breaching()
        now = self._clock() if now is None else now
        with self._lock:
            if breaching:
                self._healthy_since = None
                if self._breach_since is None:
                    self._breach_since = now
                if self._level >= len(BROWNOUT_STEPS):
                    return self._level
                if self._level == 0:
                    ref, wait = self._breach_since, self._engage_after_s
                else:
                    ref, wait = self._last_transition, self._escalate_after_s
                if now - ref >= wait:
                    self._transition(self._level, "engage", now)
                    self._level += 1
            else:
                self._breach_since = None
                if self._healthy_since is None:
                    self._healthy_since = now
                if self._level > 0:
                    ref = max(
                        self._healthy_since,
                        self._last_transition
                        if self._last_transition is not None
                        else self._healthy_since,
                    )
                    if now - ref >= self._revert_after_s:
                        self._level -= 1
                        self._transition(self._level, "revert", now)
            if self.metrics is not None:
                self._g_level.set(self._level)
            return self._level

    def _transition(self, step_index: int, action: str, now: float) -> None:
        # Caller holds self._lock.
        step = BROWNOUT_STEPS[step_index]
        self._last_transition = now
        fns = self._actions.get(step)
        error = None
        if fns is not None:
            fn = fns[0] if action == "engage" else fns[1]
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - ladder must keep moving
                error = f"{type(e).__name__}: {e}"
                if self.metrics is not None:
                    self._c_action_errors.inc()
        record = {
            "t_mono": round(now, 3),
            "wall_time": time.time(),
            "step": step,
            "action": action,
            "level_after": (
                step_index + 1 if action == "engage" else step_index
            ),
        }
        if error is not None:
            record["action_error"] = error
        self._transitions.append(record)
        del self._transitions[:-_TRANSITION_LOG_LIMIT]
        if self.metrics is not None:
            (self._c_engaged if action == "engage" else self._c_reverted)[
                step
            ].inc()
        tracing.add_span(
            f"brownout.{action}", 0.0, step=step,
            level=record["level_after"],
        )
        events_mod.emit(
            f"brownout.{action}",
            f"{step} (level {record['level_after']})",
            severity="warning" if action == "engage" else "info",
            step=step,
            level=record["level_after"],
        )

    def force_level(self, level: int, now: Optional[float] = None) -> int:
        """Jump straight to `level` (drills, the overload-smoke stage),
        running every engage/revert action crossed on the way."""
        if not 0 <= level <= len(BROWNOUT_STEPS):
            raise ValueError(f"level must be in [0, {len(BROWNOUT_STEPS)}]")
        now = self._clock() if now is None else now
        with self._lock:
            while self._level < level:
                self._transition(self._level, "engage", now)
                self._level += 1
            while self._level > level:
                self._level -= 1
                self._transition(self._level, "revert", now)
            if self.metrics is not None:
                self._g_level.set(self._level)
            return self._level

    # -- introspection -------------------------------------------------------

    @property
    def level(self) -> int:
        return self._level

    def active_steps(self) -> Tuple[str, ...]:
        return BROWNOUT_STEPS[: self._level]

    def export(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "max_level": len(BROWNOUT_STEPS),
                "active_steps": list(BROWNOUT_STEPS[: self._level]),
                "ladder": list(BROWNOUT_STEPS),
                "breaching": self._breach_since is not None,
                "engage_after_s": self._engage_after_s,
                "escalate_after_s": self._escalate_after_s,
                "revert_after_s": self._revert_after_s,
                "transitions": list(self._transitions),
            }

    # -- background loop -----------------------------------------------------

    def start(self, period_s: float = 1.0) -> None:
        """Spawn the control loop as a daemon (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 - keep the loop alive
                    pass

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"{self._name}-loop"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
