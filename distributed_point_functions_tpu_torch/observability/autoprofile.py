"""SLO-triggered auto-profiling: capture a profiler trace on latency burn.

The port of the JAX package's `observability/autoprofile.py`. The
`/profilez` endpoint captures a bounded trace on demand, but an operator
paged for a latency SLO burn arrives minutes after the interesting
window. An `AutoProfiler` registered on an `slo.SloTracker` burn listener
captures ONE bounded profile the moment a latency objective transitions
into breach, while the slowness is still happening. Guard rails keep it
from becoming its own incident:

* only latency-kind objectives trigger (default `p99_ms_max`; a
  compile-budget counter breach is a bug report, not a profiling
  opportunity);
* a **cooldown** (default 5 min) bounds capture frequency -- a flapping
  objective (breach, recover, breach) fires at most once per window,
  and a continuing breach never re-fires at all (burn *transitions*
  trigger, not burn states -- `SloTracker.add_burn_listener` semantics);
* one capture at a time (a burn arriving mid-capture is counted as
  suppressed, never queued);
* captures land in a bounded **ring buffer** of the last N entries
  {ts_unix, objective, metric, observed, threshold, log_dir,
  duration_ms}, listed on `/statusz` (oldest evicted).

The capture itself is the same machinery `/profilez` uses -- a fresh
`tempfile.mkdtemp` directory and `utils/profiling.trace` (a
`torch.profiler` trace of the host's operators and the card's kernels,
written as `trace.json`) around a sleep of `duration_ms` -- factored into
`capture_profile` so the admin endpoint and the auto-profiler report
identical artifacts. `capture_fn` and `clock` are injectable for tests.
Like everything in `observability/`, this module imports only stdlib +
`utils/`.
"""

from __future__ import annotations

import collections
import tempfile
import threading
import time
from typing import Callable, Optional

from ..utils.profiling import trace

__all__ = ["AutoProfiler", "capture_profile", "LATENCY_KINDS"]

# SLO kinds whose burn means "the process is slow right now" — the only
# ones worth pointing a profiler at.
LATENCY_KINDS = ("p99_ms_max",)


def capture_profile(
    profile_dir: Optional[str],
    name: str,
    duration_ms: float,
) -> dict:
    """One bounded profiler capture into a fresh directory (the /profilez
    recipe): serving threads keep running while the profiler records
    them for `duration_ms`. Returns {log_dir, duration_ms}."""
    log_dir = tempfile.mkdtemp(
        prefix=f"dpf-profile-{name}-", dir=profile_dir
    )
    t0 = time.perf_counter()
    with trace(log_dir):
        time.sleep(duration_ms / 1e3)
    return {
        "log_dir": log_dir,
        "duration_ms": round((time.perf_counter() - t0) * 1e3, 1),
    }


class AutoProfiler:
    """Capture-on-burn policy over an `SloTracker`.

    Constructing one registers it as a burn listener on `tracker`;
    there is nothing else to wire. `async_capture=True` (the default)
    runs the capture on a daemon thread so the evaluation that detected
    the burn — often a /healthz scrape — is not blocked for the capture
    window; tests pass `async_capture=False` plus a stub `capture_fn`
    and a fake `clock` for determinism.
    """

    def __init__(
        self,
        tracker,
        profile_dir: Optional[str] = None,
        duration_ms: float = 500.0,
        cooldown_s: float = 300.0,
        max_captures: int = 8,
        name: str = "auto",
        kinds=LATENCY_KINDS,
        capture_fn: Optional[Callable[[dict], dict]] = None,
        clock=time.monotonic,
        async_capture: bool = True,
    ):
        self._profile_dir = profile_dir
        self._duration_ms = float(duration_ms)
        self._cooldown_s = float(cooldown_s)
        self._name = name
        self._kinds = tuple(kinds)
        self._capture_fn = capture_fn
        self._clock = clock
        self._async = async_capture
        self._lock = threading.Lock()
        self._in_flight = False
        self._last_fire: Optional[float] = None
        self._captures = collections.deque(maxlen=max(1, max_captures))
        self._fired = 0
        self._suppressed_cooldown = 0
        self._suppressed_inflight = 0
        self._suppressed_kind = 0
        tracker.add_burn_listener(self._on_burn)

    # -- burn listener ------------------------------------------------------

    def _on_burn(self, record: dict) -> None:
        if record.get("kind") not in self._kinds:
            with self._lock:
                self._suppressed_kind += 1
            return
        now = self._clock()
        with self._lock:
            if self._in_flight:
                self._suppressed_inflight += 1
                return
            if (
                self._last_fire is not None
                and now - self._last_fire < self._cooldown_s
            ):
                self._suppressed_cooldown += 1
                return
            self._in_flight = True
            self._last_fire = now
        if self._async:
            threading.Thread(
                target=self._capture, args=(record,), daemon=True,
                name=f"{self._name}-profiler",
            ).start()
        else:
            self._capture(record)

    def _capture(self, record: dict) -> None:
        entry = {
            "ts_unix": round(time.time(), 3),
            "objective": record.get("name"),
            "metric": record.get("metric"),
            "observed": record.get("observed"),
            "threshold": record.get("threshold"),
            "burn_s": record.get("burn_s"),
        }
        try:
            fn = self._capture_fn
            result = (
                fn(record)
                if fn is not None
                else capture_profile(
                    self._profile_dir, self._name, self._duration_ms
                )
            )
            if isinstance(result, dict):
                entry.update(result)
            elif result is not None:
                entry["log_dir"] = str(result)
        except Exception as e:  # noqa: BLE001 - a failed capture is an entry
            entry["error"] = f"{type(e).__name__}: {e}"[:200]
        finally:
            with self._lock:
                self._captures.append(entry)
                self._fired += 1
                self._in_flight = False

    # -- reading ------------------------------------------------------------

    def captures(self) -> list:
        with self._lock:
            return list(self._captures)

    def export(self) -> dict:
        with self._lock:
            return {
                "kinds": list(self._kinds),
                "duration_ms": self._duration_ms,
                "cooldown_s": self._cooldown_s,
                "fired": self._fired,
                "in_flight": self._in_flight,
                "suppressed_cooldown": self._suppressed_cooldown,
                "suppressed_inflight": self._suppressed_inflight,
                "suppressed_kind": self._suppressed_kind,
                "captures": list(self._captures),
            }
