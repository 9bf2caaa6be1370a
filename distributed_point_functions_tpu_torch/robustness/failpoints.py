"""Seeded fault-injection registry with named sites.

A *failpoint* is a named hook compiled into a hot path:

    failpoints.fire("transport.tcp.recv", error=TransportError)
    data = failpoints.mutate("transport.response", data)

Disarmed (the default, and the only state production ever sees) each
hook is one attribute read — the module-level helpers bail on
`registry.armed` before taking any lock. Armed, the spec for the site
decides what happens:

    action="error"     raise (the site's `error` constructor, or
                       `FailpointError`) after an optional delay
    action="oom"       raise `SimulatedResourceExhausted`, whose text
                       carries RESOURCE_EXHAUSTED, standing in for
                       an allocator failure
    action="delay"     sleep `delay_ms` and continue (latency spike)
    action="corrupt"   (mutate sites) flip one byte at a seeded index
    action="truncate"  (mutate sites) cut the payload short

Scheduling knobs make fault *schedules* scriptable and deterministic:
`times` bounds how often a spec fires (None = every hit), `after`
skips the first N hits, and `probability` draws from the registry's
seeded RNG — the same seed replays the same schedule.

Activation comes from code only: `registry.arm(...)`, or
`registry.arm_from_string(...)` with specs such as

    "transport.tcp.recv=error:times=2;batcher.evaluate=delay:delay_ms=50"

No environment variable arms a site or seeds the registry (the JAX
package reads two at process start; the port does not).

Stdlib-only on purpose: this module sits at the bottom of the layer
DAG so the transports, the batcher, the Leader's helper leg, and the
device dispatch bracket can all call it without an upward edge.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, Optional

__all__ = [
    "FailpointError",
    "SimulatedResourceExhausted",
    "FailpointSpec",
    "FailpointRegistry",
    "default_failpoints",
    "set_default_failpoints",
    "fire",
    "mutate",
]

_ACTIONS = ("error", "oom", "delay", "corrupt", "truncate")


class FailpointError(RuntimeError):
    """An injected fault (the default error an armed site raises)."""


class SimulatedResourceExhausted(FailpointError):
    """An injected device OOM. The message carries RESOURCE_EXHAUSTED
    so an OOM triage cannot tell it from the allocator failure it
    stands in for."""


@dataclasses.dataclass
class FailpointSpec:
    """One armed site: what happens and how often."""

    site: str
    action: str = "error"
    times: Optional[int] = 1  # max fires; None = unlimited
    after: int = 0  # skip the first `after` hits
    probability: float = 1.0
    delay_ms: float = 0.0
    message: str = ""
    hits: int = 0  # times the site was reached while armed
    fired: int = 0  # times the fault actually happened

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(
                f"unknown failpoint action {self.action!r} "
                f"(one of {_ACTIONS})"
            )


class FailpointRegistry:
    """Thread-safe site -> spec map with a seeded RNG.

    `armed` is a plain attribute deliberately: the module-level `fire`/
    `mutate` helpers read it lock-free as the disarmed fast path, and
    it is only ever flipped under the lock.
    """

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            seed = 0
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._specs: Dict[str, FailpointSpec] = {}
        # Arming observers: cb(site, spec_or_None) on arm / disarm /
        # clear. Plain callables so this module stays stdlib-only; the
        # event journal (observability/events.py) subscribes downward.
        self._arm_listeners: list = []
        self.armed = False

    # -- arming -------------------------------------------------------------

    def add_arm_listener(self, listener: Callable) -> None:
        """Register `listener(site, spec)` to observe arming changes
        (`spec` is None on disarm). Called outside the registry lock;
        exceptions are swallowed — fault injection must never be the
        fault."""
        with self._lock:
            self._arm_listeners.append(listener)

    def _notify_arm(self, site: str, spec: Optional[FailpointSpec]) -> None:
        with self._lock:
            listeners = list(self._arm_listeners)
        for listener in listeners:
            try:
                listener(site, spec)
            except Exception:  # noqa: BLE001 - observers must not break arming
                pass

    def arm(self, site: str, action: str = "error", **kwargs) -> FailpointSpec:
        """Arm `site`; returns the live spec (its `hits`/`fired`
        counters update as the schedule plays out)."""
        spec = FailpointSpec(site=site, action=action, **kwargs)
        with self._lock:
            self._specs[site] = spec
            self.armed = True
        self._notify_arm(site, spec)
        return spec

    def arm_from_string(self, text: str) -> None:
        """Parse `site=action[:k=v[:k=v...]]` specs separated by `;`
        (one site per item)."""
        for item in text.split(";"):
            item = item.strip()
            if not item:
                continue
            head, _, opts = item.partition(":")
            site, _, action = head.partition("=")
            kwargs: dict = {}
            for opt in filter(None, opts.split(":")):
                k, _, v = opt.partition("=")
                k = k.strip()
                if k in ("times", "after"):
                    kwargs[k] = None if v == "none" else int(v)
                elif k in ("probability", "p"):
                    kwargs["probability"] = float(v)
                elif k == "delay_ms":
                    kwargs[k] = float(v)
                elif k in ("message", "msg"):
                    kwargs["message"] = v
                else:
                    raise ValueError(f"unknown failpoint option {k!r}")
            self.arm(site.strip(), (action or "error").strip(), **kwargs)

    def disarm(self, site: str) -> None:
        with self._lock:
            removed = self._specs.pop(site, None)
            self.armed = bool(self._specs)
        if removed is not None:
            self._notify_arm(site, None)

    def clear(self) -> None:
        with self._lock:
            sites = list(self._specs)
            self._specs.clear()
            self.armed = False
        for site in sites:
            self._notify_arm(site, None)

    def spec(self, site: str) -> Optional[FailpointSpec]:
        with self._lock:
            return self._specs.get(site)

    # -- firing -------------------------------------------------------------

    def _draw(self, site: str) -> Optional[FailpointSpec]:
        """Count a hit at `site`; returns the spec iff it fires now."""
        with self._lock:
            spec = self._specs.get(site)
            if spec is None:
                return None
            spec.hits += 1
            if spec.hits <= spec.after:
                return None
            if spec.times is not None and spec.fired >= spec.times:
                return None
            if spec.probability < 1.0 and (
                self._rng.random() >= spec.probability
            ):
                return None
            spec.fired += 1
            return spec

    def fire(
        self, site: str, error: Optional[Callable[[str], Exception]] = None
    ) -> None:
        """Run `site`'s armed schedule: sleep for a delay action, raise
        for error/oom. `error` lets the instrumented site supply its
        native exception type (e.g. TransportError) without this module
        importing it."""
        spec = self._draw(site)
        if spec is None:
            return
        if spec.delay_ms > 0.0:
            time.sleep(spec.delay_ms / 1e3)
        if spec.action == "delay":
            return
        message = spec.message or f"injected fault at {site}"
        if spec.action == "oom":
            raise SimulatedResourceExhausted(
                f"RESOURCE_EXHAUSTED: {message}"
            )
        if spec.action in ("corrupt", "truncate"):
            # A mutate action on a fire-only site is an arming mistake;
            # surface it instead of silently not injecting.
            raise FailpointError(
                f"failpoint {site} armed with mutate action "
                f"{spec.action!r} but reached via fire()"
            )
        ctor = error if error is not None else FailpointError
        raise ctor(message)

    def mutate(self, site: str, data: bytes) -> bytes:
        """Apply a corrupt/truncate schedule to `data` (frame-level
        sites); non-mutate actions behave as in `fire`."""
        spec = self._draw(site)
        if spec is None or not data:
            return data
        if spec.delay_ms > 0.0:
            time.sleep(spec.delay_ms / 1e3)
        if spec.action == "delay":
            return data
        if spec.action == "corrupt":
            with self._lock:
                idx = self._rng.randrange(len(data))
                flip = 1 + self._rng.randrange(255)
            out = bytearray(data)
            out[idx] ^= flip
            return bytes(out)
        if spec.action == "truncate":
            with self._lock:
                cut = self._rng.randrange(len(data))
            return data[:cut]
        message = spec.message or f"injected fault at {site}"
        if spec.action == "oom":
            raise SimulatedResourceExhausted(
                f"RESOURCE_EXHAUSTED: {message}"
            )
        raise FailpointError(message)

    # -- reading ------------------------------------------------------------

    def export(self) -> dict:
        with self._lock:
            return {
                "armed": self.armed,
                "seed": self.seed,
                "sites": {
                    site: {
                        "action": s.action,
                        "times": s.times,
                        "after": s.after,
                        "probability": s.probability,
                        "delay_ms": s.delay_ms,
                        "hits": s.hits,
                        "fired": s.fired,
                    }
                    for site, s in sorted(self._specs.items())
                },
            }


_default_registry = FailpointRegistry()


def default_failpoints() -> FailpointRegistry:
    return _default_registry


def set_default_failpoints(registry: FailpointRegistry) -> FailpointRegistry:
    global _default_registry
    _default_registry = registry
    return registry


def fire(
    site: str, error: Optional[Callable[[str], Exception]] = None
) -> None:
    """Module-level hook for instrumented sites; one attribute read
    when nothing is armed."""
    registry = _default_registry
    if registry.armed:
        registry.fire(site, error=error)


def mutate(site: str, data: bytes) -> bytes:
    registry = _default_registry
    if registry.armed:
        return registry.mutate(site, data)
    return data
