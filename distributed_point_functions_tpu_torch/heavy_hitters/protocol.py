"""Private heavy hitters: hierarchy config, frontier machine, pruning.

The two-server protocol of arXiv:2012.14884 ("Lightweight Techniques
for Private Heavy Hitters") in its count-query form, on the same
two-server aggregation model as `pir/server.py`:

1. every client secret-shares its value as an incremental DPF key pair
   with value 1 at every hierarchy level (`client.py`);
2. both servers sweep the hierarchy level-synchronized: at level ℓ each
   evaluates ALL keys over the current candidate-prefix frontier in one
   budgeted batch (`aggregator.LevelAggregator`) and obtains an
   additive share of the per-prefix count histogram;
3. the share vectors are exchanged and summed mod `2^count_bits` — the
   ONLY values ever revealed are prefix counts;
4. prefixes with count < `threshold` are pruned; survivors descend
   (each spawns its `2^level_bits` children) and the sweep repeats
   until full-length values emerge.

**Threshold semantics**: a value with true count >= t survives every
level (each of its prefixes counts at least as often as the value), so
the final survivor set equals `{v : count(v) >= t}` exactly — the sweep
is lossless for true heavy hitters, which is what the end-to-end test
pins against the plaintext oracle. Counts are exact (no sampling); mod
`2^count_bits` wrap-around is the additive group, so `count_bits` must
exceed `log2(num_clients)`.

This module is transport-free: `run_protocol` drives two in-process
`HeavyHittersServer`s; `session.py` runs the same sweep Leader/Helper
over a `serving.transport.Transport`.

The port of the JAX package's `heavy_hitters/protocol.py`: the same
config, sweep and pruning. A server evaluates on its `device` (None: the
CUDA card, raising without one; "cpu" runs the kernels' plain
versions) and takes no mesh (the key-sharded sum is not ported).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..dpf import DistributedPointFunction, DpfParameters
from ..value_types import IntType
from .aggregator import LevelAggregator


class ProtocolError(RuntimeError):
    """The peers disagree on round order or message shape."""


class IntegrityError(ProtocolError):
    """A frame failed its checksum: the bytes changed in flight.

    Distinct from the base class on purpose: a bad CRC means THIS copy
    of the message is damaged, not that the peer speaks an older wire
    version — so the session retries the round instead of downgrading
    its wire version."""


@dataclasses.dataclass(frozen=True)
class HeavyHittersConfig:
    """Shape of one heavy-hitters deployment (shared by both servers
    and every client).

    `domain_bits` is the bit width of client values (byte-aligned for
    string values), `level_bits` how many bits each round reveals (the
    hierarchy step), `threshold` the minimum count a prefix needs to
    survive, `count_bits` the additive count group (must exceed
    `log2(num_clients)`; <= 32 so counts sum as one device limb).
    """

    domain_bits: int
    level_bits: int = 4
    threshold: int = 2
    count_bits: int = 32
    budget_bytes: Optional[int] = None

    def __post_init__(self):
        if not (1 <= self.level_bits <= self.domain_bits):
            raise ValueError("need 1 <= level_bits <= domain_bits")
        if self.domain_bits > 64:
            raise ValueError("domain_bits > 64 not supported")
        if self.threshold < 1:
            raise ValueError("threshold must be >= 1")
        if self.count_bits not in (8, 16, 32):
            raise ValueError("count_bits must be 8, 16, or 32")

    def level_bit_widths(self) -> List[int]:
        """Cumulative revealed bits per round: lb, 2lb, ..., domain."""
        widths = list(
            range(self.level_bits, self.domain_bits, self.level_bits)
        )
        widths.append(self.domain_bits)
        return widths

    @property
    def num_rounds(self) -> int:
        return len(self.level_bit_widths())

    def value_type(self) -> IntType:
        return IntType(self.count_bits)

    def parameters(self) -> List[DpfParameters]:
        vt = self.value_type()
        return [
            DpfParameters(w, vt) for w in self.level_bit_widths()
        ]

    def make_dpf(self, device=None) -> DistributedPointFunction:
        return DistributedPointFunction.create_incremental(
            self.parameters(), device=device
        )


def config_fingerprint(config: "HeavyHittersConfig") -> dict:
    """The config fields a checkpoint must agree on to be resumable
    (JSON-stable; `budget_bytes` is a per-process tuning knob and
    deliberately not part of the identity)."""
    return {
        "domain_bits": config.domain_bits,
        "level_bits": config.level_bits,
        "threshold": config.threshold,
        "count_bits": config.count_bits,
    }


def reconstruct_counts(
    share0: np.ndarray, share1: np.ndarray, count_bits: int
) -> np.ndarray:
    """Combine the two servers' share vectors into plaintext counts."""
    if share0.shape != share1.shape:
        raise ProtocolError(
            f"share shape mismatch: {share0.shape} vs {share1.shape}"
        )
    mask = np.uint64((1 << count_bits) - 1)
    total = (
        share0.astype(np.uint64) + share1.astype(np.uint64)
    ) & mask
    return total


@dataclasses.dataclass
class RoundStats:
    """Observable outcome of one sweep round (feeds serving metrics)."""

    round_index: int
    bit_width: int
    frontier_width: int
    survivors: int
    prune_ratio: float
    wall_ms: float = 0.0
    bytes_sent: int = 0
    bytes_received: int = 0


@dataclasses.dataclass
class HeavyHittersResult:
    """Final heavy hitters (value point, count) plus per-round stats."""

    heavy_hitters: List[Tuple[int, int]]
    rounds: List[RoundStats]

    def as_dict(self) -> Dict[int, int]:
        return {int(a): int(c) for a, c in self.heavy_hitters}


class FrontierSweep:
    """The candidate-prefix state machine both deployments share.

    Rounds map 1:1 onto hierarchy levels. `frontier` holds the strictly
    ascending domain indices to count this round; `observe_counts`
    prunes below threshold and descends survivors. The machine is done
    when the last level's survivors are known or the frontier empties.
    """

    def __init__(self, config: HeavyHittersConfig):
        self._config = config
        self._widths = config.level_bit_widths()
        self.round_index = 0
        self.frontier: np.ndarray = np.arange(
            1 << self._widths[0], dtype=np.uint64
        )
        self.done = False
        self.result: List[Tuple[int, int]] = []
        self.rounds: List[RoundStats] = []

    @property
    def config(self) -> HeavyHittersConfig:
        return self._config

    @property
    def bit_width(self) -> int:
        return self._widths[self.round_index]

    def observe_counts(self, counts: np.ndarray) -> RoundStats:
        """Prune the frontier with this round's reconstructed counts
        and advance; returns the round's stats."""
        if self.done:
            raise ProtocolError("sweep already finished")
        counts = np.asarray(counts, dtype=np.uint64)
        if counts.shape != self.frontier.shape:
            raise ProtocolError(
                f"got {counts.shape[0]} counts for "
                f"{self.frontier.shape[0]} prefixes"
            )
        keep = counts >= np.uint64(self._config.threshold)
        survivors = self.frontier[keep]
        stats = RoundStats(
            round_index=self.round_index,
            bit_width=self.bit_width,
            frontier_width=int(self.frontier.shape[0]),
            survivors=int(survivors.shape[0]),
            prune_ratio=float(1.0 - survivors.shape[0] / self.frontier.shape[0]),
        )
        self.rounds.append(stats)
        last = self.round_index == len(self._widths) - 1
        if last or survivors.shape[0] == 0:
            self.done = True
            if last:
                self.result = [
                    (int(a), int(c))
                    for a, c in zip(survivors, counts[keep])
                ]
        else:
            step = self._widths[self.round_index + 1] - self.bit_width
            base = survivors.astype(np.uint64) << np.uint64(step)
            self.frontier = (
                base[:, None]
                | np.arange(1 << step, dtype=np.uint64)[None, :]
            ).reshape(-1)
            self.round_index += 1
        return stats

    # -- checkpoint/resume --------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable state after the last *completed* round.
        Captures everything `restore` needs to continue the sweep,
        plus the config fingerprint so a checkpoint can never resume
        under a different hierarchy."""
        return {
            "config": config_fingerprint(self._config),
            "round_index": int(self.round_index),
            "frontier": [int(p) for p in self.frontier],
            "done": bool(self.done),
            "result": [[int(a), int(c)] for a, c in self.result],
            "rounds": [dataclasses.asdict(r) for r in self.rounds],
        }

    @classmethod
    def restore(
        cls, config: "HeavyHittersConfig", state: dict
    ) -> "FrontierSweep":
        """Rebuild a sweep from `snapshot()` output. Raises
        `ProtocolError` when the checkpoint belongs to a different
        hierarchy config."""
        if state.get("config") != config_fingerprint(config):
            raise ProtocolError(
                f"checkpoint config {state.get('config')} does not match "
                f"{config_fingerprint(config)}"
            )
        sweep = cls(config)
        sweep.round_index = int(state["round_index"])
        if not 0 <= sweep.round_index < config.num_rounds:
            raise ProtocolError(
                f"checkpoint round {sweep.round_index} outside the sweep"
            )
        sweep.frontier = np.asarray(state["frontier"], dtype=np.uint64)
        sweep.done = bool(state["done"])
        sweep.result = [(int(a), int(c)) for a, c in state["result"]]
        sweep.rounds = [RoundStats(**r) for r in state["rounds"]]
        return sweep


class HeavyHittersServer:
    """One aggregation server's sweep state over its clients' keys.

    Wraps a `LevelAggregator`; `evaluate_round` enforces the
    level-synchronized order (round r = hierarchy level r) so the cut
    states cached by round r−1 always serve round r.

    `allow_resume=True` relaxes the order check for fault recovery —
    at a privacy-neutral cost, since every answer is still a share of
    a frontier the Leader chose:

    * a round AHEAD of the expected one is served from the root (a
      fresh process joining a sweep mid-way; `LevelAggregator` proves
      from-root equals resume bit-for-bit), and
    * the LAST round already answered may be replayed with the same
      frontier (the Leader lost our response to a corrupt frame or a
      crash after we advanced) and returns the cached shares —
      idempotent, so a resend cannot double-count.

    Replays of older rounds or with a different frontier still raise
    `ProtocolError`.
    """

    def __init__(
        self,
        config: HeavyHittersConfig,
        keys: Sequence,
        budget_bytes: Optional[int] = None,
        metrics=None,
        allow_resume: bool = False,
        device=None,
    ):
        self._config = config
        self._dpf = config.make_dpf(device)
        self._agg = LevelAggregator(
            self._dpf,
            keys,
            budget_bytes=(
                budget_bytes if budget_bytes is not None
                else config.budget_bytes
            ),
            metrics=metrics,
        )
        self._next_round = 0
        self._allow_resume = allow_resume
        # (round_index, frontier tuple, shares) of the last answered
        # round — the replay cache.
        self._last_round: Optional[tuple] = None

    @property
    def config(self) -> HeavyHittersConfig:
        return self._config

    @property
    def num_keys(self) -> int:
        return self._agg.num_keys

    @property
    def aggregator(self) -> LevelAggregator:
        return self._agg

    @property
    def launches(self) -> dict:
        """Kernel launches of this server's evaluations, by kernel."""
        return self._agg.launches

    def evaluate_round(
        self, round_index: int, frontier: Sequence[int]
    ) -> np.ndarray:
        if round_index >= self._config.num_rounds:
            raise ProtocolError(f"round {round_index} beyond the sweep")
        if round_index != self._next_round:
            replay = (
                self._allow_resume
                and self._last_round is not None
                and round_index == self._last_round[0]
            )
            if replay:
                if tuple(int(p) for p in frontier) != self._last_round[1]:
                    raise ProtocolError(
                        f"replay of round {round_index} with a "
                        f"different frontier"
                    )
                return self._last_round[2].copy()
            if not (self._allow_resume and round_index > self._next_round):
                raise ProtocolError(
                    f"round {round_index} out of order (expected "
                    f"{self._next_round})"
                )
        shares = self._agg.evaluate_level(round_index, frontier)
        self._next_round = round_index + 1
        if self._allow_resume:
            self._last_round = (
                round_index,
                tuple(int(p) for p in frontier),
                shares.copy(),
            )
        return shares

    def reset(self) -> None:
        """Start a fresh sweep over the same staged keys."""
        self._agg.reset()
        self._next_round = 0
        self._last_round = None


def run_protocol(
    server0: HeavyHittersServer,
    server1: HeavyHittersServer,
    on_round=None,
) -> HeavyHittersResult:
    """Drive a full in-process sweep over two servers (the
    transport-free reference sweep; `session.py` is the deployed
    equivalent). `on_round(stats)` observes each round."""
    config = server0.config
    if server1.config != config:
        raise ProtocolError("servers disagree on the hierarchy config")
    sweep = FrontierSweep(config)
    while not sweep.done:
        frontier = sweep.frontier
        r = sweep.round_index
        s0 = server0.evaluate_round(r, frontier)
        s1 = server1.evaluate_round(r, frontier)
        counts = reconstruct_counts(s0, s1, config.count_bits)
        stats = sweep.observe_counts(counts)
        if on_round is not None:
            on_round(stats)
    return HeavyHittersResult(
        heavy_hitters=sweep.result, rounds=sweep.rounds
    )


def plaintext_heavy_hitters(
    values: Sequence[Union[bytes, str, int]],
    config: HeavyHittersConfig,
) -> Dict[int, int]:
    """The plaintext oracle: exact counts filtered at the threshold.

    Hierarchical pruning never loses a true heavy hitter (every prefix
    of a count-t value counts >= t), so the private sweep must equal
    this exactly."""
    from .client import encode_value

    counts = collections.Counter(
        encode_value(v, config.domain_bits) for v in values
    )
    return {
        a: c for a, c in counts.items() if c >= config.threshold
    }
