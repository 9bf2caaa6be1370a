"""The Multiple Interval Containment gate (eprint 2020/1392, Fig. 14): the
port of the JAX package's `fss_gates/multiple_interval_containment.py`
(the reference's `dcf/fss_gates/multiple_interval_containment.{h,cc}`).

The two parties get additive shares, mod N = 2^log_group_size, of 1 for
every public interval [p_j, q_j] that holds the unmasked input, plus the
output mask r_out_j:

* `gen(r_in, r_out)` (host) makes one DCF key at gamma = (N - 1 + r_in)
  mod N with beta = 1 over `IntType(128)`, as the reference does, and per
  interval the additive shares of the correction z_j for the masked
  bounds' wrap-arounds (Lemmas 1-2 and Theorem 3 of the paper);
* `batch_eval_device(keys, x)` stages each DCF key once and repeats it 2 ni
  times on the device (`StagedKeyBatch.repeat`, ni intervals), evaluates
  the DCF in one batch at x + N - 1 - p_j and x + N - 1 - q'_j (q'_j =
  q_j + 1 mod N) for every key (one K8 walk and one K3 hash for the whole
  batch), and combines on the device in limb arithmetic: the public bits
  [x > p_j] - [x > q'_j] for party 1, minus s_p, plus s_q', plus z_j,
  reduced mod N by `mask_top_bits`. It returns int32[n, ni, 4] limbs;
  `batch_eval` converts them to the JAX package's lists of Python ints.

The masked points and the public bits are numpy uint64 arrays up to
log_group_size 64 and Python ints above; the device work is the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..dcf import DcfKey, DistributedComparisonFunction, points_array
from ..dpf import StagedKeyBatch, distinct_rows
from ..ops import aes, limb
from ..ops.words import to_numpy, to_tensors
from ..value_types import IntType


@dataclasses.dataclass(frozen=True)
class Interval:
    lower_bound: int
    upper_bound: int


@dataclasses.dataclass(frozen=True)
class MicParameters:
    log_group_size: int
    intervals: Tuple[Interval, ...]

    def __init__(self, log_group_size: int, intervals: Sequence[Interval]):
        object.__setattr__(self, "log_group_size", log_group_size)
        object.__setattr__(self, "intervals", tuple(intervals))


@dataclasses.dataclass
class MicKey:
    dcf_key: DcfKey
    output_mask_share: List[int]


@dataclasses.dataclass
class MicStagedKeys:
    """A key batch staged for `batch_eval_device`: the DCF keys with each
    key repeated 2 ni times in a row (its p points, then its q' points),
    the output mask shares int32[n, ni, 4], and which keys are party 1's."""

    n: int
    dcf: StagedKeyBatch
    z: torch.Tensor
    party_one: np.ndarray  # bool[n]


class MultipleIntervalContainmentGate:
    """See the module docstring. `device` is where evaluation runs (None:
    the CUDA card; "cpu": the kernels' plain versions)."""

    def __init__(self, parameters: MicParameters, *, device=None):
        if parameters.log_group_size < 1 or parameters.log_group_size > 127:
            raise ValueError("log_group_size must be in [1, 127]")
        if not parameters.intervals:
            raise ValueError("at least one interval is required")
        n = 1 << parameters.log_group_size
        for iv in parameters.intervals:
            if not (0 <= iv.lower_bound < n) or not (0 <= iv.upper_bound < n):
                raise ValueError(
                    "interval bounds should be between 0 and 2^log_group_size")
            if iv.lower_bound > iv.upper_bound:
                raise ValueError("interval upper bounds should be >= lower bound")
        self.parameters = parameters
        self._n = n
        self.dcf = DistributedComparisonFunction.create(
            parameters.log_group_size, IntType(128), device=device)
        # Host arrays of the public shifts and bounds: numpy uint64 (mod
        # 2^64 wraps, masked to N) up to 2^64, Python ints above.
        dtype = np.uint64 if parameters.log_group_size <= 64 else object
        p = [iv.lower_bound for iv in parameters.intervals]
        q_prime = [(iv.upper_bound + 1) % n for iv in parameters.intervals]
        self._mask = dtype(n - 1) if dtype is np.uint64 else n - 1
        self._p = np.array(p, dtype=dtype)
        self._q_prime = np.array(q_prime, dtype=dtype)
        self._shifts = np.array([(n - 1 - b) % n for b in p + q_prime], dtype=dtype)

    @classmethod
    def create(cls, parameters: MicParameters, *, device=None):
        return cls(parameters, device=device)

    # -- key generation (host) --------------------------------------------------

    def gen(self, r_in: int, r_out: Sequence[int], prng=None) -> Tuple[MicKey, MicKey]:
        """The two parties' keys for input mask `r_in` and the per-interval
        output masks `r_out`. `prng` is a `SecurePrng` for the mask shares
        (default `BasicRng`, the operating system's CSPRNG); the DCF's root
        seeds come from the DPF's key generation."""
        if prng is None:
            from .prng import BasicRng

            prng = BasicRng()
        if len(r_out) != len(self.parameters.intervals):
            raise ValueError(
                "count of output masks should be equal to the number of intervals")
        n = self._n
        if not (0 <= r_in < n):
            raise ValueError("input mask should be between 0 and 2^log_group_size")
        for r in r_out:
            if not (0 <= r < n):
                raise ValueError("output mask should be between 0 and 2^log_group_size")

        gamma = (n - 1 + r_in) % n
        key0, key1 = self.dcf.generate_keys(gamma, 1)
        k0 = MicKey(dcf_key=key0, output_mask_share=[])
        k1 = MicKey(dcf_key=key1, output_mask_share=[])
        for i, iv in enumerate(self.parameters.intervals):
            p, q = iv.lower_bound, iv.upper_bound
            q_prime = (q + 1) % n
            alpha_p = (p + r_in) % n
            alpha_q = (q + r_in) % n
            alpha_q_prime = (q + 1 + r_in) % n
            z = (r_out[i]
                 + (1 if alpha_p > alpha_q else 0)
                 + (-1 if alpha_p > p else 0)
                 + (1 if alpha_q_prime > q_prime else 0)
                 + (1 if alpha_q == n - 1 else 0)) % n
            z0 = prng.rand128() % n
            k0.output_mask_share.append(z0)
            k1.output_mask_share.append((z - z0) % n)
        return k0, k1

    # -- evaluation (device) ------------------------------------------------------

    def stage_keys(self, keys: Sequence[MicKey]) -> MicStagedKeys:
        """Stage a key batch on the device once: each distinct DCF key's
        arrays are assembled once (`DistributedPointFunction.
        stage_key_batch`), then every key is repeated 2 ni times on the
        device."""
        n, ni = len(keys), len(self.parameters.intervals)
        if n == 0:
            raise ValueError("keys must not be empty")
        uniq, rows = distinct_rows(keys)
        for k in uniq:
            if len(k.output_mask_share) != ni:
                raise ValueError(
                    "count of output mask shares should be equal to the number of intervals")
        z = np.stack([aes.u128s_to_limbs([int(v) for v in k.output_mask_share])
                      for k in uniq])[rows]
        base = self.dcf.stage_keys([k.dcf_key for k in keys])
        (z,) = to_tensors([z], base.parties.device)
        party_one = np.array([k.dcf_key.key.party != 0 for k in uniq])[rows]
        return MicStagedKeys(n=n, dcf=base.repeat(2 * ni), z=z, party_one=party_one)

    def batch_eval_device(self, keys: Sequence[MicKey], evaluation_points,
                          staged: MicStagedKeys = None) -> torch.Tensor:
        """Each key at its own masked input (ints, or a numpy uint64 array
        up to log_group_size 64): the shares int32[n, ni, 4] on the device,
        128-bit limbs reduced mod N. Pass `staged` from `stage_keys` to reuse
        its staging (then `keys` may be None)."""
        if staged is None:
            if keys is None:
                raise ValueError("either keys or staged must be provided")
            if len(keys) != len(evaluation_points):
                raise ValueError("keys and evaluation_points must have the same size")
            staged = self.stage_keys(keys)
        elif keys is not None and len(keys) != staged.n:
            raise ValueError("keys and staged batch size mismatch")
        if len(evaluation_points) != staged.n:
            raise ValueError("keys and evaluation_points must have the same size")
        n, ni = staged.n, len(self.parameters.intervals)
        x = points_array(evaluation_points, self.parameters.log_group_size,
                         lambda _: "masked input should be between 0 and 2^log_group_size")
        x = x[:, None]
        # Per key: the ni points x + N - 1 - p_j, then the ni at q'_j.
        shifted = (x + self._shifts[None, :]) & self._mask
        public = ((x > self._p[None, :]).astype(np.int32)
                  - (x > self._q_prime[None, :]).astype(np.int32))
        public[~staged.party_one] = 0
        (t,) = to_tensors([public.astype(np.uint32)], staged.z.device)  # before any launch
        s = self.dcf.batch_evaluate(None, shifted.reshape(-1), staged=staged.dcf)
        s = s.reshape(n, 2, ni, 4)
        # The public term mod 2^128: -1 is all ones.
        high = -(t < 0).to(torch.int32)
        t = torch.stack([t, high, high, high], dim=-1)
        y = limb.add(limb.sub(limb.add(s[:, 1], staged.z), s[:, 0]), t)
        return limb.mask_top_bits(y, self.parameters.log_group_size)

    def batch_eval(self, keys: Sequence[MicKey], evaluation_points) -> List[List[int]]:
        """Each key at its own masked input: per key, one share mod N per
        interval (Python ints)."""
        if len(keys) != len(evaluation_points):
            raise ValueError("keys and evaluation_points must have the same size")
        y = to_numpy(self.batch_eval_device(keys, evaluation_points))
        if self.parameters.log_group_size <= 64:
            u64 = y[..., 0].astype(np.uint64) | (y[..., 1].astype(np.uint64) << np.uint64(32))
            return u64.tolist()
        ints = aes.limbs_to_u128s(y)
        ni = y.shape[1]
        return [ints[i * ni:(i + 1) * ni] for i in range(y.shape[0])]

    def eval(self, key: MicKey, x: int) -> List[int]:
        """Single-key evaluation: one share per interval."""
        return self.batch_eval([key], [x])[0]
