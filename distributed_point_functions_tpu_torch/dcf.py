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

There is one engine and no fallback.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .dpf import DistributedPointFunction, DpfKey, DpfParameters
from .value_types import ValueType


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
        """Evaluate each key at its own point: int32[len(keys), nlimbs]
        shares on the device."""
        if keys is None and staged is None:
            raise ValueError("either keys or staged must be provided")
        if keys is not None and len(keys) != len(evaluation_points):
            raise ValueError("keys and evaluation_points must have the same size")
        lds = self.log_domain_size
        for x in evaluation_points:
            if not (0 <= x < (1 << lds)):
                raise ValueError(f"evaluation point {x} out of range")
        if staged is None:
            staged = self.stage_keys(keys)
        # Level hl adds its value where bit (lds - 1 - hl) of x is 0.
        xs = np.array(evaluation_points, dtype=np.uint64 if lds <= 64 else object)
        bit_pos = np.arange(lds - 1, -1, -1, dtype=xs.dtype)
        masks = ((xs[None, :] >> bit_pos[:, None]) & 1) == 0
        return self.dpf.evaluate_and_accumulate(
            staged, list(evaluation_points), masks, evaluation_points_rightshift=1)
