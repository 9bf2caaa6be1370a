"""Failure machinery of the serving runtime, copied from the JAX package.

* `failpoints` -- a seeded registry of named fault sites in the
  transports, the batcher worker, the Leader's Helper leg and the
  snapshot rotation. Armed from code only; disarmed it costs one
  attribute read a site.
* `breaker` -- the closed / open / half-open circuit breaker the Leader
  puts on its Helper leg;
* `checkpoint` -- the atomic JSON store the heavy-hitters Leader keeps
  its sweep's frontier in, to resume after a crash.

Stdlib only, at the bottom of the layers: every layer may call it.
"""

from .breaker import CircuitBreaker
from .checkpoint import CheckpointError, CheckpointStore
from .failpoints import (
    FailpointError,
    FailpointRegistry,
    FailpointSpec,
    SimulatedResourceExhausted,
    default_failpoints,
    fire,
    mutate,
    set_default_failpoints,
)

__all__ = [
    "CheckpointError",
    "CheckpointStore",
    "CircuitBreaker",
    "FailpointError",
    "FailpointRegistry",
    "FailpointSpec",
    "SimulatedResourceExhausted",
    "default_failpoints",
    "fire",
    "mutate",
    "set_default_failpoints",
]
