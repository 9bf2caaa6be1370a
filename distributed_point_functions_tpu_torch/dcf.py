"""Distributed Comparison Functions on the incremental DPF: the port of the
JAX package's `dcf.py`.

A DCF gives the two parties additive shares of `beta` iff `x < alpha`, and
of 0 otherwise (Algorithm 7 of eprint 2022/866, the reference's
`dcf/distributed_comparison_function.{h,cc}`):

* `create` builds an incremental DPF with one hierarchy level per domain
  bit, levels 0 .. log_domain_size - 1, all of the DCF's value type;
* `generate_keys` sets level i's value to `beta` when bit
  (log_domain_size - 1 - i) of alpha is 1 and to 0 otherwise, and keys the
  DPF on `alpha >> 1`: the last bit is carried by the last level's value;
* `batch_evaluate` runs the DPF's multi-key engine
  (`evaluate_and_accumulate`: one K8 launch walks every tree level of the
  whole batch) with `evaluation_points_rightshift=1`, adding level i's value
  wherever bit (log_domain_size - 1 - i) of x is 0.

Any value type of `value_types.py` serves as beta; a `TupleType`'s shares
come back as a tuple of limb tensors. A staged batch repeats each key on
the device with `StagedKeyBatch.repeat` (the MIC gate evaluates every key
once per interval).

There is one engine and no fallback.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .dpf import (
    DistributedPointFunction,
    DpfKey,
    DpfParameters,
    point_bits,
    points_to_limbs,
)
from .ops.words import to_tensor
from .value_types import ValueType


def points_array(points, bits: int, message) -> np.ndarray:
    """Points of a domain of 2^bits as a numpy array: uint64 up to 2^64
    (a uint64 array passes as it is), Python ints (object) above. A point
    outside the domain raises ValueError(message(point))."""
    if isinstance(points, np.ndarray) and points.dtype == np.uint64 and bits <= 64:
        if bits < 64 and len(points) and int(points.max()) >> bits:
            raise ValueError(message(int(points[np.argmax(points >> np.uint64(bits))])))
        return points
    for x in points:
        if not (0 <= x < (1 << bits)):
            raise ValueError(message(x))
    return np.array([int(x) for x in points], dtype=np.uint64 if bits <= 64 else object)


class DcfKey:
    """One party's DCF key: a DpfKey of the DCF's incremental DPF."""

    def __init__(self, key: DpfKey):
        self.key = key


class DistributedComparisonFunction:
    """DCF over a domain of `2^log_domain_size` elements, evaluated on
    `device` (None: the CUDA card; "cpu": the kernels' plain versions)."""

    def __init__(self, log_domain_size: int, value_type: ValueType,
                 security_parameter: float = 0.0, *, device=None):
        if log_domain_size < 1:
            raise ValueError("a DCF must have log_domain_size >= 1")
        self.log_domain_size = log_domain_size
        self.value_type = value_type
        params = [DpfParameters(i, value_type, security_parameter)
                  for i in range(log_domain_size)]
        self.dpf = DistributedPointFunction.create_incremental(params, device=device)

    @classmethod
    def create(cls, log_domain_size: int, value_type: ValueType,
               security_parameter: float = 0.0, *, device=None):
        return cls(log_domain_size, value_type, security_parameter, device=device)

    def generate_keys(self, alpha: int, beta, _root_seeds=None) -> Tuple[DcfKey, DcfKey]:
        """The two parties' keys for `x < alpha -> beta`; `_root_seeds` as
        in `DistributedPointFunction.generate_keys_incremental`."""
        if not (0 <= alpha < (1 << self.log_domain_size)):
            raise ValueError("alpha out of domain range")
        self.value_type.validate(beta)
        zero = self.value_type.zero()
        betas = [beta if (alpha >> (self.log_domain_size - i - 1)) & 1 else zero
                 for i in range(self.log_domain_size)]
        k0, k1 = self.dpf.generate_keys_incremental(alpha >> 1, betas, _root_seeds)
        return DcfKey(k0), DcfKey(k1)

    def evaluate(self, key: DcfKey, x: int):
        """Single-point evaluation; returns the host share value."""
        out = self.batch_evaluate([key], [x])
        return self.value_type.to_python(out, (0,))

    def stage_keys(self, keys: Sequence[DcfKey]):
        """Stage a key batch on the device once, for any number of
        `batch_evaluate(None, points, staged=...)` calls."""
        return self.dpf.stage_key_batch([k.key for k in keys])

    def batch_evaluate(self, keys: Sequence[DcfKey],
                       evaluation_points: Sequence[int], staged=None):
        """Evaluate each key at its own point (ints, or for a domain of at
        most 2^64 a numpy uint64 array): shares on the device, a value of
        batch shape [len(keys)] (int32[n, nlimbs], or a tuple of them for
        a `TupleType`)."""
        if keys is None and staged is None:
            raise ValueError("either keys or staged must be provided")
        if keys is not None and len(keys) != len(evaluation_points):
            raise ValueError("keys and evaluation_points must have the same size")
        xs = points_array(evaluation_points, self.log_domain_size,
                          lambda x: f"evaluation point {x} out of range")
        if staged is None:
            staged = self.stage_keys(keys)
        # Level hl adds its value where bit (lds - 1 - hl) of x is 0, read
        # on the device.
        points = to_tensor(points_to_limbs(xs, len(xs)), staged.parties.device)
        masks = point_bits(points, range(self.log_domain_size - 1, -1, -1)) == 0
        return self.dpf.evaluate_and_accumulate(
            staged, xs, masks, evaluation_points_rightshift=1)
