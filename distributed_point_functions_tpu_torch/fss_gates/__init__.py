"""FSS gates on the DCF: the port of the JAX package's `fss_gates`."""

from .multiple_interval_containment import (
    Interval,
    MicKey,
    MicParameters,
    MultipleIntervalContainmentGate,
)

__all__ = [
    "Interval",
    "MicKey",
    "MicParameters",
    "MultipleIntervalContainmentGate",
]
