"""Blackbox verification prober: golden queries through the real
serving path, checked bit-for-bit against a plaintext oracle.

The port of the JAX package's `serving/prober.py` (its `Prober` and its
`CrossReplicaProbe`), over the port's sessions: the
golden requests are made by the port's own clients, and the probes run
on the session's device through the same kernels as production queries.

Two-server PIR fails *silently*: a single flipped bit in either
party's share XORs straight into the reconstructed record, every
transport frame still parses, every status code is 200, and every
latency SLO stays green. The only way to know a deployment is serving
the *right bits* is to continuously ask it questions whose answers are
known in advance — through the same batcher, planner, transport, and
device paths production queries take — and assert bit-identity on
what comes back.

The `Prober` owns a small set of golden indices into the served
database (the operator hands it the plaintext records, which the
serving side of a deployment has by construction) and per cycle runs
one probe of each enabled kind:

    pir_materialized   batched plain pair, tier floor cleared (a tiny
                       probe batch plans materialized naturally — the
                       floor can only demote, so "forcing" the top
                       tier means removing the constraint)
    pir_streaming      batched plain pair with the process tier floor
                       forced to streaming for the probe's duration
    pir_chunked        same, forced to chunked
    pir_unbatched      the same pair straight through
                       `server.handle_plain_request`, bypassing the
                       batcher (separates batcher bugs from eval bugs)
    leader_e2e         a full encrypted LeaderRequest through
                       `session.handle_request` — helper leg,
                       one-time-pad unmask and all (only when an
                       `encrypter` is provided); a session answering
                       in degraded (leader-share-only) mode is flagged
                       `degraded`, not failed — the answer is *known*
                       to be unreconstructable then; each result also
                       carries the request's merged critical-path
                       summary (`critical_path` key: the skew-corrected
                       helper_net / helper_queue / helper_compute
                       split) so /probez shows where probe latency went
    hh_sweep           a miniature heavy-hitters sweep over two
                       in-memory servers built from golden reports,
                       checked against `plaintext_heavy_hitters`
    sparse_kv          (sparse sessions) golden key→value pairs through
                       the batched cuckoo bucket-space path; each key's
                       reconstructed candidate set must resolve to its
                       oracle value
    sparse_absent      (sparse sessions) a golden key guaranteed absent
                       from the table; it must keep resolving to
                       not-found — a well-formed wrong value for a
                       missing key is the silent failure mode unique to
                       key-value PIR

For the dense probes the two plain responses are XORed together and
compared byte-for-byte against the oracle records (`xor(share0,
share1) == record` is the CGKS reconstruction identity — any
corruption anywhere in either evaluation breaks it).

Every probe lands in per-kind bounded history (`/probez`), counters
and a latency histogram in the session's metrics registry
(`prober.*`), and the event journal on state changes
(`prober.mismatch` / `prober.error` / `prober.recovered`). Failure
listeners (`add_failure_listener`) fire on mismatch/error — wiring
`BundleManager.on_probe_failure` there makes a wrong-bits incident
self-documenting. `freshness()` reports the age of each kind's last
pass; `AdminServer` turns a stale bit-identity probe into a 503 on
`/healthz` so the load balancer drains a process that cannot prove it
serves correct bits. `rate_floor_objective()` hands back a `rate_min`
SLO objective over `prober.probes` so a silently *stopped* prober is
itself a burn signal.

The background loop (`start()`) jitters its period (so a fleet's
probers do not synchronize) and bounds its duty cycle: after a cycle
that took `d` seconds it sleeps at least `d * (1/max_duty_cycle - 1)`,
so probing can never eat more than `max_duty_cycle` of the process
even when probes get slow — the prober must observe overload, not
contribute to it.

Layering: this module sits *above* `serving/` and `heavy_hitters/`
and is NOT imported by `serving/__init__.py`: import `Prober` as
`distributed_point_functions_tpu_torch.serving.prober.Prober`. The
package resolves `serving.CrossReplicaProbe` on first access only, so
that importing `serving/` loads nothing of `heavy_hitters/`.
"""

from __future__ import annotations

import collections
import contextlib
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..heavy_hitters.client import HeavyHittersClient
from ..heavy_hitters.protocol import (
    HeavyHittersConfig,
    HeavyHittersServer,
    plaintext_heavy_hitters,
    run_protocol,
)
from ..observability import critical_path
from ..observability import events as events_mod
from ..observability.slo import SloObjective
from ..pir.client import DenseDpfPirClient
from ..pir.server import set_tier_floor, tier_floor
from ..pir.sparse_client import (
    CuckooHashingSparseDpfPirClient,
    _is_prefix_padded_with_zeros,
)
from ..prng import xor_bytes

__all__ = ["CrossReplicaProbe", "Prober", "PROBE_STATUSES"]

PROBE_STATUSES = ("pass", "mismatch", "error", "degraded")

# Probe kinds whose pass proves bit-identity of the dense serving path;
# a stale last-pass on any of these degrades /healthz.
_IDENTITY_KINDS = (
    "pir_materialized",
    "pir_streaming",
    "pir_chunked",
    "pir_unbatched",
)

# Sparse identity kinds: golden key→value pairs reconstructing through
# the batched cuckoo path (`sparse_kv`), and a golden *absent* key that
# must keep resolving to not-found (`sparse_absent` — a server that
# starts answering wrong-but-well-formed values for absent keys is the
# silent failure mode unique to key-value PIR). Stale ⇒ /healthz 503,
# same as the dense identity kinds.
_SPARSE_IDENTITY_KINDS = ("sparse_kv", "sparse_absent")


class Prober:
    """Continuous blackbox canary over one serving session.

    `session` is a `PlainSession`/`LeaderSession` (anything with
    `handle_request` and a `server`); `records` the full plaintext
    database (the oracle). `indices` picks the golden queries (default:
    first, middle, last — distinct). `encrypter` enables the
    `leader_e2e` probe; `hh_values` (+ optional `hh_config`) enables
    the `hh_sweep` probe. `clock` must be monotonic.

    For a sparse (cuckoo key-value) session pass `sparse_records` — the
    full key→value plaintext mapping — instead of (or alongside)
    `records`: the dense probe kinds only run when `records` is given
    (a sparse session answers bucket-space queries, so dense golden
    *indices* are meaningless there), and `sparse_records` enables the
    `sparse_kv` + `sparse_absent` kinds. `sparse_absent_key` overrides
    the derived guaranteed-absent golden key.
    """

    def __init__(
        self,
        session,
        records: Optional[Sequence[bytes]] = None,
        *,
        indices: Optional[Sequence[int]] = None,
        encrypter=None,
        hh_values: Optional[Sequence] = None,
        hh_config: Optional[HeavyHittersConfig] = None,
        sparse_records: Optional[Dict[bytes, bytes]] = None,
        sparse_absent_key: Optional[bytes] = None,
        period_s: float = 5.0,
        jitter: float = 0.2,
        max_duty_cycle: float = 0.05,
        history: int = 32,
        freshness_window_s: Optional[float] = None,
        name: str = "prober",
        metrics=None,
        journal=None,
        clock=time.monotonic,
        rng_seed: int = 0,
    ):
        if not records and not sparse_records:
            raise ValueError("records must not be empty")
        if not 0.0 < max_duty_cycle <= 1.0:
            raise ValueError("max_duty_cycle must be in (0, 1]")
        self._session = session
        self._name = name
        self._period_s = float(period_s)
        self._jitter = float(jitter)
        self._max_duty_cycle = float(max_duty_cycle)
        self._freshness_window_s = (
            float(freshness_window_s)
            if freshness_window_s is not None
            else 3.0 * self._period_s
        )
        self._metrics = (
            metrics
            if metrics is not None
            else getattr(session, "metrics", None)
        )
        self._journal = journal
        self._clock = clock
        self._rng = random.Random(rng_seed)
        self._lock = threading.Lock()
        self._started_mono = clock()
        self._seq = 0
        self._cycles = 0
        self._failure_listeners: List[Callable[[dict], None]] = []
        self._history: Dict[str, collections.deque] = {}
        self._history_cap = max(1, int(history))
        # kind -> monotonic time of last pass / last status string
        self._last_pass: Dict[str, float] = {}
        self._last_status: Dict[str, str] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # The last leader_e2e probe's merged critical-path summary
        # (None until one runs against a critical-path-aware session).
        self._last_critical: Optional[dict] = None

        self._dense = bool(records)
        self._e2e = None
        if records:
            n = len(records)
            if indices is None:
                indices = sorted({0, n // 2, n - 1})
            indices = [int(i) for i in indices]
            for i in indices:
                if not 0 <= i < n:
                    raise ValueError(
                        f"golden index {i} out of bounds for {n}"
                    )
            self._indices = indices
            self._expected = [bytes(records[i]) for i in indices]

            # Golden requests are precomputed once: DPF keys are
            # stateless and reusable, so steady-state probing does no
            # key generation. `create_plain_requests` never calls the
            # encrypter, so a dummy suffices when no real one is
            # configured.
            client = DenseDpfPirClient(
                n,
                encrypter
                if encrypter is not None
                else (lambda pt, info: pt),
            )
            self._client = client
            self._db_size = n
            self._plain_pair = client.create_plain_requests(indices)
            if encrypter is not None:
                request, state = client.create_request(indices)
                self._e2e = (request, state, client)
        else:
            # Sparse-only prober: the dense kinds are disabled (a
            # cuckoo session answers bucket-space queries; dense golden
            # *indices* have no oracle meaning there).
            self._indices = []
            self._expected = []
            self._client = None
            self._db_size = 0
            self._plain_pair = None
        # Snapshot rotation: the database generation the golden pairs
        # are keyed to, plus the SnapshotManagers to pin during each
        # probe so a probe's two shares never straddle a flip (see
        # `bind_snapshots` / `rotate_goldens`).
        self._generation = getattr(
            getattr(session, "server", None), "database", None
        )
        self._generation = getattr(self._generation, "generation", 0)
        self._snapshot_pins: List = []

        # Sparse goldens: a handful of known key→value pairs plus one
        # key guaranteed absent, probed through the batched cuckoo path
        # (`_probe_sparse`). The plain request pair covers all of them
        # at once and is precomputed like the dense pair.
        self._sparse_pair = None
        self._sparse_keys: List[bytes] = []
        self._sparse_expected: List[bytes] = []
        self._sparse_absent: Optional[bytes] = None
        self._sparse_client = None
        self._sparse_num_hashes = 0
        if sparse_records:
            self._sparse_client = CuckooHashingSparseDpfPirClient.create(
                session.server.public_params,
                encrypter
                if encrypter is not None
                else (lambda pt, info: pt),
            )
            self._sparse_num_hashes = (
                session.server.public_params.num_hash_functions
            )
            self._set_sparse_goldens(sparse_records, sparse_absent_key)

        self._hh = None
        if hh_values:
            cfg = (
                hh_config
                if hh_config is not None
                else HeavyHittersConfig(
                    domain_bits=8, level_bits=4, threshold=2
                )
            )
            device = session.server.device
            hh_client = HeavyHittersClient(cfg, device=device)
            keys0, keys1 = [], []
            for value in hh_values:
                k0, k1 = hh_client.generate_report(value)
                keys0.append(k0)
                keys1.append(k1)
            self._hh = (
                HeavyHittersServer(cfg, keys0, device=device),
                HeavyHittersServer(cfg, keys1, device=device),
                plaintext_heavy_hitters(list(hh_values), cfg),
            )

    # -- wiring -------------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    def set_journal(self, journal):
        """Point probe events at a (replica-scoped) journal; None
        restores the process journal."""
        self._journal = journal
        return journal

    def kinds(self) -> List[str]:
        """The probe kinds this prober runs each cycle."""
        out = list(_IDENTITY_KINDS) if self._dense else []
        if self._sparse_pair is not None:
            out.extend(_SPARSE_IDENTITY_KINDS)
        if self._e2e is not None:
            out.append("leader_e2e")
        if self._hh is not None:
            out.append("hh_sweep")
        return out

    def add_failure_listener(self, listener: Callable[[dict], None]) -> None:
        """Register `listener(result)` for every mismatch/error probe
        (degraded-mode flags do not fire it — a degraded session is a
        *known* state, not a new incident). Exceptions are swallowed."""
        with self._lock:
            self._failure_listeners.append(listener)

    def rotate_goldens(
        self,
        records: Sequence[bytes],
        *,
        indices: Optional[Sequence[int]] = None,
        generation: Optional[int] = None,
    ) -> None:
        """Re-key the golden (index, plaintext) pairs to a rotated
        database generation. DPF keys select by *index*, so unchanged
        golden indices keep their precomputed requests — only the
        oracle plaintexts swap; passing new `indices` regenerates the
        requests too. Rotation preserves the database size
        (`swap_database` enforces it), so `records` must match."""
        if len(records) != self._db_size:
            raise ValueError(
                f"rotated records count {len(records)} != database size "
                f"{self._db_size} (rotation preserves geometry)"
            )
        with self._lock:
            if indices is not None:
                indices = [int(i) for i in indices]
                for i in indices:
                    if not 0 <= i < self._db_size:
                        raise ValueError(
                            f"golden index {i} out of bounds for "
                            f"{self._db_size}"
                        )
                if indices != self._indices:
                    self._indices = indices
                    self._plain_pair = (
                        self._client.create_plain_requests(indices)
                    )
                    if self._e2e is not None:
                        request, state = self._client.create_request(
                            indices
                        )
                        self._e2e = (request, state, self._client)
            self._expected = [
                bytes(records[i]) for i in self._indices
            ]
            if generation is not None:
                self._generation = int(generation)
            generation_now = self._generation
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        journal.emit(
            "prober.goldens_rotated",
            f"golden pairs re-keyed to generation {generation_now}",
            severity="info",
            generation=generation_now,
        )

    def _set_sparse_goldens(self, sparse_records, absent_key) -> None:
        """(Re)build the sparse golden set from a key→value mapping:
        up to three present keys (sorted, for determinism), one
        guaranteed-absent key, and the precomputed batched plain
        request pair covering all of them. Caller holds `_lock` (or is
        `__init__`)."""
        norm = {}
        for k, v in sparse_records.items():
            kb = k.encode() if isinstance(k, str) else bytes(k)
            norm[kb] = v.encode() if isinstance(v, str) else bytes(v)
        keys = sorted(norm)[:3]
        if absent_key is None:
            # Keep the current absent golden while it stays absent; a
            # write batch that introduces it forces a re-derivation.
            absent_key = self._sparse_absent or b"prober-absent"
            while absent_key in norm:
                absent_key += b"!"
        else:
            absent_key = (
                absent_key.encode()
                if isinstance(absent_key, str)
                else bytes(absent_key)
            )
            if absent_key in norm:
                raise ValueError(
                    "sparse_absent_key is present in sparse_records"
                )
        regenerate = (
            keys != self._sparse_keys
            or absent_key != self._sparse_absent
            or self._sparse_pair is None
        )
        self._sparse_keys = keys
        self._sparse_expected = [norm[k] for k in keys]
        self._sparse_absent = absent_key
        if regenerate:
            self._sparse_pair = self._sparse_client.create_plain_requests(
                keys + [absent_key]
            )

    def rotate_sparse_goldens(
        self,
        records: Dict[bytes, bytes],
        *,
        absent_key: Optional[bytes] = None,
        generation: Optional[int] = None,
    ) -> None:
        """Re-key the sparse golden key→value pairs to a rotated
        database generation. Unlike dense rotation the key set may
        change (upserts add keys), so golden keys are re-picked from
        the new mapping and the request pair regenerated when they
        differ; the absent golden is kept while it stays absent."""
        if not records:
            raise ValueError("rotated sparse records must not be empty")
        if self._sparse_client is None:
            raise ValueError("prober has no sparse goldens to rotate")
        with self._lock:
            self._set_sparse_goldens(records, absent_key)
            if generation is not None:
                self._generation = int(generation)
            generation_now = self._generation
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        journal.emit(
            "prober.goldens_rotated",
            f"sparse golden pairs re-keyed to generation {generation_now}",
            severity="info",
            generation=generation_now,
        )

    def bind_snapshots(self, manager, records_provider=None):
        """Track a `SnapshotManager` through rotations: every probe
        pins it (a probe's two shares must evaluate against ONE
        generation — the pin holds a pending flip off until the probe
        lands), and, when `records_provider(to_generation)` is given,
        every applied flip rotates the goldens to the new generation's
        plaintexts within the same flip callback — i.e. before the
        next probe cycle can run against stale oracles. Bind BOTH
        parties' managers in a two-party deployment so neither side
        flips mid-probe. Returns `manager` for chaining."""
        with self._lock:
            if manager not in self._snapshot_pins:
                self._snapshot_pins.append(manager)
        if records_provider is not None:
            def on_flip(record):
                records = records_provider(record["to_generation"])
                if not records:
                    return
                if isinstance(records, dict):
                    self.rotate_sparse_goldens(
                        records, generation=record["to_generation"]
                    )
                else:
                    self.rotate_goldens(
                        records, generation=record["to_generation"]
                    )

            manager.add_flip_listener(on_flip)
        return manager

    def _pinned_managers(self) -> List:
        with self._lock:
            managers = list(self._snapshot_pins)
        session_manager = getattr(self._session, "snapshots", None)
        if session_manager is not None and session_manager not in managers:
            managers.append(session_manager)
        return managers

    def rate_floor_objective(
        self, threshold: Optional[float] = None
    ) -> SloObjective:
        """A `rate_min` SLO objective over `prober.probes`: the probe
        rate falling below `threshold`/s means the prober died or
        stalled — silence must burn, not reassure. The default floor is
        a quarter of the configured steady-state rate (generous slack
        for jitter and duty-cycle stretching)."""
        if threshold is None:
            threshold = 0.25 * len(self.kinds()) / self._period_s
        return SloObjective(
            name=f"{self._name}_rate_floor",
            kind="rate_min",
            metric="prober.probes",
            threshold=threshold,
            severity="soft",
        )

    # -- probes -------------------------------------------------------------

    def _reconstruct(self, resp0, resp1) -> List[bytes]:
        masked0 = resp0.dpf_pir_response.masked_response
        masked1 = resp1.dpf_pir_response.masked_response
        if len(masked0) != len(masked1):
            raise ValueError(
                f"share count mismatch: {len(masked0)} vs {len(masked1)}"
            )
        return [xor_bytes(a, b) for a, b in zip(masked0, masked1)]

    def _check_records(self, got: List[bytes]) -> Optional[str]:
        """None iff bit-identical to the oracle; else a detail string."""
        if len(got) != len(self._expected):
            return (
                f"answer count {len(got)} != {len(self._expected)} golden"
            )
        for idx, want, have in zip(self._indices, self._expected, got):
            if want != have:
                return (
                    f"index {idx}: expected {want.hex()[:32]}.. "
                    f"got {have.hex()[:32]}.."
                )
        return None

    def _issue_batched(self, request):
        """One plain request through the session's batched path. A
        plain-role session takes it through `handle_request` (deadline,
        metrics, trace — the full front door); a Leader/Helper session
        role-dispatches plain requests away, so there the probe enters
        at the batcher hook (`_dispatch_plain`), which is the same
        shared-batch device path production shares ride."""
        server = self._session.server
        if getattr(server, "role", "plain") == "plain":
            return self._session.handle_request(request)
        return server._dispatch_plain(request)

    def _probe_tier(self, tier: Optional[str]) -> Optional[str]:
        """Run the batched plain pair at a forced planner tier (None =
        cleared floor, which a tiny batch plans materialized)."""
        prev = tier_floor()
        set_tier_floor(tier)
        try:
            req0, req1 = self._plain_pair
            resp0 = self._issue_batched(req0)
            resp1 = self._issue_batched(req1)
        finally:
            set_tier_floor(prev)
        return self._check_records(self._reconstruct(resp0, resp1))

    def _probe_unbatched(self) -> Optional[str]:
        req0, req1 = self._plain_pair
        server = self._session.server
        resp0 = server.handle_plain_request(req0)
        resp1 = server.handle_plain_request(req1)
        return self._check_records(self._reconstruct(resp0, resp1))

    def _probe_leader_e2e(self) -> Optional[str]:
        request, state, client = self._e2e
        response = self._session.handle_request(request)
        # The probe just rode the real two-party path, so the analyzer's
        # freshest Leader summary IS this request's critical path; stash
        # it for `_run_one` to attach to the /probez result.
        self._last_critical = critical_path.default_analyzer().last(
            "leader"
        )
        got = client.handle_response(response, state)
        return self._check_records(got)

    def _probe_sparse(self, absent: bool) -> Optional[str]:
        """Run the sparse golden pair through the batched path and
        resolve candidates client-side (the same zero-padded prefix
        match `CuckooHashingSparseDpfPirClient` applies). With
        `absent=False` every golden key must resolve to its oracle
        value; with `absent=True` the absent golden must resolve to
        nothing — a well-formed wrong value for a missing key is the
        silent failure mode unique to key-value PIR."""
        with self._lock:
            pair = self._sparse_pair
            keys = list(self._sparse_keys)
            expected = list(self._sparse_expected)
            absent_key = self._sparse_absent
            num_hashes = self._sparse_num_hashes
        req0, req1 = pair
        resp0 = self._issue_batched(req0)
        resp1 = self._issue_batched(req1)
        raw = self._reconstruct(resp0, resp1)
        queries = keys + [absent_key]
        if len(raw) != 2 * num_hashes * len(queries):
            return (
                f"candidate count {len(raw)} != "
                f"2 x {num_hashes} hashes x {len(queries)} queries"
            )

        def resolve(i: int) -> Optional[bytes]:
            for j in range(num_hashes):
                k = 2 * (num_hashes * i + j)
                if _is_prefix_padded_with_zeros(raw[k], queries[i]):
                    return raw[k + 1]
            return None

        if absent:
            got = resolve(len(queries) - 1)
            if got is not None:
                return (
                    f"absent key {absent_key!r} resolved to "
                    f"{got.hex()[:32]}.. (want not-found)"
                )
            return None
        for i, (key, want) in enumerate(zip(keys, expected)):
            got = resolve(i)
            if got is None:
                return f"golden key {key!r}: not found (want present)"
            if not _is_prefix_padded_with_zeros(got, want):
                return (
                    f"golden key {key!r}: expected {want.hex()[:32]}.. "
                    f"got {got.hex()[:32]}.."
                )
        return None

    def _probe_hh_sweep(self) -> Optional[str]:
        server0, server1, expected = self._hh
        server0.reset()
        server1.reset()
        result = run_protocol(server0, server1).as_dict()
        if result != expected:
            return f"heavy hitters {result} != oracle {expected}"
        return None

    def _run_one(self, kind: str) -> dict:
        t0 = time.perf_counter()
        status = "pass"
        detail = None
        try:
            # Pin every bound SnapshotManager for the probe's duration:
            # the two shares of a golden pair (and the oracle they are
            # checked against) must all belong to ONE generation, so a
            # pending rotation flip waits out the probe instead of
            # landing between its submissions.
            with contextlib.ExitStack() as stack:
                for manager in self._pinned_managers():
                    stack.enter_context(manager.pin())
                if kind == "pir_materialized":
                    detail = self._probe_tier(None)
                elif kind == "pir_streaming":
                    detail = self._probe_tier("streaming")
                elif kind == "pir_chunked":
                    detail = self._probe_tier("chunked")
                elif kind == "pir_unbatched":
                    detail = self._probe_unbatched()
                elif kind == "leader_e2e":
                    detail = self._probe_leader_e2e()
                elif kind == "sparse_kv":
                    detail = self._probe_sparse(absent=False)
                elif kind == "sparse_absent":
                    detail = self._probe_sparse(absent=True)
                elif kind == "hh_sweep":
                    detail = self._probe_hh_sweep()
                else:  # pragma: no cover - kinds() is the source of truth
                    raise ValueError(f"unknown probe kind {kind}")
            if detail is not None:
                status = "mismatch"
        except Exception as e:  # noqa: BLE001 - a probe must not kill the loop
            status = "error"
            detail = f"{type(e).__name__}: {e}"[:300]
        if status != "pass" and getattr(self._session, "degraded", False):
            # A Leader in leader-share-only mode *cannot* reconstruct —
            # flag it distinctly: the bits are not wrong, they are
            # declared absent.
            status = "degraded"
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        with self._lock:
            self._seq += 1
            seq = self._seq
        result = {
            "kind": kind,
            "status": status,
            "ms": ms,
            "detail": detail,
            "seq": seq,
            "t_wall": round(time.time(), 3),
            "t_mono": round(self._clock(), 3),
        }
        if kind == "leader_e2e" and self._last_critical is not None:
            # Where the probe's own latency went: the skew-corrected
            # helper-leg decomposition for this request (/probez).
            result["critical_path"] = self._last_critical
        return result

    def _record(self, result: dict) -> None:
        kind, status = result["kind"], result["status"]
        now = result["t_mono"]
        with self._lock:
            history = self._history.setdefault(
                kind, collections.deque(maxlen=self._history_cap)
            )
            history.append(result)
            prev_status = self._last_status.get(kind)
            self._last_status[kind] = status
            if status == "pass":
                self._last_pass[kind] = now
            listeners = list(self._failure_listeners)
        status_metric = {
            "pass": "prober.passes",
            "mismatch": "prober.mismatches",
            "error": "prober.errors",
            "degraded": "prober.degraded",
        }[status]
        if self._metrics is not None:
            self._metrics.counter("prober.probes").inc()
            self._metrics.counter(status_metric, {"kind": kind}).inc()
            self._metrics.histogram(
                "prober.probe_ms", labels={"kind": kind}
            ).observe(result["ms"])
        journal = (
            self._journal
            if self._journal is not None
            else events_mod.default_journal()
        )
        if status == "mismatch":
            journal.emit(
                "prober.mismatch",
                f"{kind}: {result['detail']}",
                severity="error",
                probe_kind=kind,
                probe_seq=result["seq"],
            )
        elif status == "error":
            journal.emit(
                "prober.error",
                f"{kind}: {result['detail']}",
                severity="warning",
                coalesce_key=f"prober.error:{kind}",
                coalesce_s=self._period_s * 4,
                probe_kind=kind,
                probe_seq=result["seq"],
            )
        elif status == "pass" and prev_status in ("mismatch", "error"):
            journal.emit(
                "prober.recovered",
                f"{kind} passing again",
                severity="info",
                probe_kind=kind,
            )
        if status in ("mismatch", "error"):
            for listener in listeners:
                try:
                    listener(result)
                except Exception:  # noqa: BLE001 - canary must keep flying
                    pass

    def run_cycle(self) -> List[dict]:
        """Run one probe of every enabled kind; returns the results
        (tests and the CI smoke drive this directly — no thread)."""
        results = []
        for kind in self.kinds():
            result = self._run_one(kind)
            self._record(result)
            results.append(result)
        with self._lock:
            self._cycles += 1
        return results

    # -- reading ------------------------------------------------------------

    def freshness(self) -> Dict[str, dict]:
        """Per-kind probe freshness. A kind is `fresh` while its last
        pass (or, before any pass, the prober's start) is within the
        freshness window; identity kinds going stale should 503
        /healthz (see `AdminServer._healthz`)."""
        now = self._clock()
        out = {}
        with self._lock:
            for kind in self.kinds():
                last_pass = self._last_pass.get(kind)
                age = now - (
                    last_pass if last_pass is not None else self._started_mono
                )
                history = self._history.get(kind)
                last = history[-1] if history else None
                out[kind] = {
                    "last_status": self._last_status.get(kind),
                    "last_ms": last["ms"] if last else None,
                    "last_pass_age_s": (
                        round(now - last_pass, 3)
                        if last_pass is not None
                        else None
                    ),
                    "fresh": age <= self._freshness_window_s,
                    "identity": (
                        kind in _IDENTITY_KINDS
                        or kind in _SPARSE_IDENTITY_KINDS
                    ),
                    "detail": last["detail"] if last else None,
                }
        return out

    def export(self) -> dict:
        with self._lock:
            histories = {
                kind: [dict(r) for r in history]
                for kind, history in self._history.items()
            }
            cycles = self._cycles
        counts = {"pass": 0, "mismatch": 0, "error": 0, "degraded": 0}
        probes = 0
        for history in histories.values():
            for r in history:
                probes += 1
                counts[r["status"]] = counts.get(r["status"], 0) + 1
        with self._lock:
            generation = self._generation
        return {
            "name": self._name,
            "generation": generation,
            "period_s": self._period_s,
            "max_duty_cycle": self._max_duty_cycle,
            "freshness_window_s": self._freshness_window_s,
            "kinds": self.kinds(),
            "cycles": cycles,
            # Windowed over retained history (the ring is the report;
            # lifetime totals live in the metrics registry).
            "probes": probes,
            "passes": counts["pass"],
            "mismatches": counts["mismatch"],
            "errors": counts["error"],
            "degraded": counts["degraded"],
            "freshness": self.freshness(),
            "history": histories,
        }

    # -- background loop ----------------------------------------------------

    def start(self) -> "Prober":
        """Run cycles on a jittered daemon thread until `stop()`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                t0 = self._clock()
                try:
                    self.run_cycle()
                except Exception:  # noqa: BLE001 - the loop outlives probes
                    pass
                took = max(0.0, self._clock() - t0)
                jittered = self._period_s * (
                    1.0 + self._jitter * self._rng.uniform(-1.0, 1.0)
                )
                # Duty-cycle floor: a cycle that took d seconds forces
                # >= d*(1/duty - 1) of sleep, bounding prober overhead
                # at max_duty_cycle of wall time no matter how slow
                # probes get.
                floor = took * (1.0 / self._max_duty_cycle - 1.0)
                if self._stop.wait(max(jittered, floor)):
                    return

        self._thread = threading.Thread(
            target=run, daemon=True, name=f"{self._name}-loop"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class CrossReplicaProbe:
    """Cross-replica consistency canary: the SAME golden pair issued to
    EVERY replica must reconstruct bit-identically at the same
    generation.

    A fleet replicates the whole two-server deployment N times, which
    adds a failure mode no single-pair prober can see: replica A and
    replica B each pass their own bit-identity probes yet serve
    *different* databases — a botched rotation, a partial upsert, a
    replica restored from the wrong snapshot. This probe runs one
    golden plain pair through every replica's real batched path, pins
    each replica's SnapshotManagers for its attempt (a replica
    mid-flip must answer from one generation), reconstructs per
    replica, then groups answers by the generation each replica was
    serving: **within a generation group every replica's bytes must be
    identical**, and when an oracle is known for that generation they
    must also match it. Replicas on different generations are NOT
    compared against each other — during a rotation that split is
    legitimate (and the router already refuses to mix them for one
    tenant); it is reported, not failed.

    Divergence emits a `fleet.divergence` event (severity error) and
    fires the failure listeners with a prober-shaped result dict, so
    wiring `BundleManager.on_probe_failure` here snapshots the debug
    bundle the moment two replicas disagree.

    `replicas` is a sequence — or a zero-arg callable returning one,
    e.g. ``replica_set.healthy`` — of duck-typed entries carrying
    `replica_id`, `leader` (a session), optional `snapshots` /
    `helper_snapshots`, and `serving_generation()`; `fleet.Replica`
    satisfies it, but this module never imports `fleet/` (the layering
    keeps fleet -> serving one-way).
    """

    def __init__(
        self,
        replicas,
        records: Sequence[bytes],
        *,
        indices: Optional[Sequence[int]] = None,
        records_provider: Optional[Callable[[int], Sequence[bytes]]] = None,
        generation: Optional[int] = None,
        history: int = 32,
        journal=None,
        metrics=None,
        clock=time.monotonic,
        name: str = "cross_replica",
    ):
        if not records:
            raise ValueError("records must not be empty")
        self._replicas = replicas
        self._records_provider = records_provider
        self._journal = journal
        self._metrics = metrics
        self._clock = clock
        self._name = name
        self._lock = threading.Lock()
        self._history: collections.deque = collections.deque(
            maxlen=max(1, int(history))
        )
        self._seq = 0
        self._cycles = 0
        self._divergences = 0
        self._errors = 0
        self._last_pass_mono: Optional[float] = None
        self._failure_listeners: List[Callable[[dict], None]] = []

        n = len(records)
        if indices is None:
            indices = sorted({0, n // 2, n - 1})
        self._indices = [int(i) for i in indices]
        for i in self._indices:
            if not 0 <= i < n:
                raise ValueError(f"golden index {i} out of bounds for {n}")
        self._db_size = n
        self._base_generation = int(generation) if generation else 0
        self._base_expected = [bytes(records[i]) for i in self._indices]
        # One golden pair for the whole fleet: issuing the SAME DPF
        # keys everywhere is the point — any byte difference between
        # replicas' reconstructions is divergence by construction.
        client = DenseDpfPirClient(n, lambda pt, info: pt)
        self._plain_pair = client.create_plain_requests(self._indices)

    def set_journal(self, journal):
        """Point divergence events at a specific journal; None restores
        the process journal."""
        self._journal = journal
        return journal

    def add_failure_listener(self, listener: Callable[[dict], None]) -> None:
        """`listener(result)` on every divergence/error cycle (wire
        `BundleManager.on_probe_failure` here); exceptions swallowed."""
        with self._lock:
            self._failure_listeners.append(listener)

    def _replica_list(self) -> List:
        replicas = self._replicas
        return list(replicas() if callable(replicas) else replicas)

    def _oracle_for(self, generation: int) -> Optional[List[bytes]]:
        """The expected golden plaintexts at `generation`, when known:
        the constructor records at the base generation, the provider's
        everywhere else (None when it cannot say)."""
        if self._records_provider is not None:
            records = self._records_provider(generation)
            if records:
                return [bytes(records[i]) for i in self._indices]
        if generation == self._base_generation:
            return list(self._base_expected)
        return None

    @staticmethod
    def _issue(leader, request):
        """Same entry rule as `Prober._issue_batched`, per replica."""
        server = leader.server
        if getattr(server, "role", "plain") == "plain":
            return leader.handle_request(request)
        return server._dispatch_plain(request)

    def run_cycle(self) -> dict:
        """Probe every replica once; returns the cycle result dict
        (status `pass` / `mismatch` / `error`)."""
        t0 = time.perf_counter()
        req0, req1 = self._plain_pair
        answers: Dict[str, dict] = {}
        errors: Dict[str, str] = {}
        for replica in self._replica_list():
            rid = replica.replica_id
            try:
                managers = [
                    m
                    for m in (
                        getattr(replica, "snapshots", None),
                        getattr(replica, "helper_snapshots", None),
                    )
                    if m is not None
                ]
                # Pin the replica's managers: its two shares (and the
                # generation label below) must belong to ONE generation
                # even while a fleet rotation is in flight.
                with contextlib.ExitStack() as stack:
                    for manager in managers:
                        stack.enter_context(manager.pin())
                    generation = replica.serving_generation()
                    resp0 = self._issue(replica.leader, req0)
                    resp1 = self._issue(replica.leader, req1)
                    masked0 = resp0.dpf_pir_response.masked_response
                    masked1 = resp1.dpf_pir_response.masked_response
                    got = [
                        xor_bytes(a, b) for a, b in zip(masked0, masked1)
                    ]
                answers[rid] = {"generation": generation, "records": got}
            except Exception as e:  # noqa: BLE001 - per-replica fault domain
                errors[rid] = f"{type(e).__name__}: {e}"[:300]

        # Group by serving generation; bit-identity is asserted within
        # each group (cross-generation disagreement during a rotation
        # is legitimate and merely reported).
        groups: Dict[int, Dict[str, List[bytes]]] = {}
        for rid, answer in answers.items():
            groups.setdefault(answer["generation"], {})[rid] = answer[
                "records"
            ]
        divergences: List[dict] = []
        for generation, members in sorted(groups.items()):
            rids = sorted(members)
            reference_rid = rids[0]
            reference = members[reference_rid]
            oracle = self._oracle_for(generation)
            for rid in rids:
                got = members[rid]
                baseline = oracle if oracle is not None else reference
                baseline_name = (
                    "oracle" if oracle is not None else reference_rid
                )
                for idx, want, have in zip(
                    self._indices, baseline, got
                ):
                    if want != have:
                        divergences.append(
                            {
                                "replica": rid,
                                "generation": generation,
                                "index": idx,
                                "against": baseline_name,
                                "expected": want.hex()[:32],
                                "got": have.hex()[:32],
                            }
                        )
                        break

        status = "pass"
        detail = None
        if divergences:
            status = "mismatch"
            first = divergences[0]
            detail = (
                f"replica {first['replica']} diverges from "
                f"{first['against']} at generation "
                f"{first['generation']}, index {first['index']}"
            )
        elif errors and not answers:
            status = "error"
            detail = f"every replica errored: {sorted(errors)}"
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        with self._lock:
            self._seq += 1
            self._cycles += 1
            seq = self._seq
            if status == "mismatch":
                self._divergences += 1
            if errors:
                self._errors += len(errors)
            if status == "pass":
                self._last_pass_mono = self._clock()
            listeners = list(self._failure_listeners)
        result = {
            "kind": self._name,
            "status": status,
            "detail": detail,
            "ms": ms,
            "seq": seq,
            "t_wall": round(time.time(), 3),
            "t_mono": round(self._clock(), 3),
            "replicas": sorted(answers),
            "generations": {
                str(g): sorted(m) for g, m in sorted(groups.items())
            },
            "divergences": divergences,
            "errors": errors,
        }
        with self._lock:
            self._history.append(result)
        if self._metrics is not None:
            self._metrics.counter("fleet.probe_cycles").inc()
            if divergences:
                self._metrics.counter("fleet.divergences").inc(
                    len(divergences)
                )
        if status != "pass":
            journal = (
                self._journal
                if self._journal is not None
                else events_mod.default_journal()
            )
            journal.emit(
                "fleet.divergence"
                if status == "mismatch"
                else "fleet.probe_error",
                f"{self._name}: {detail}",
                severity="error",
                probe_kind=self._name,
                probe_seq=seq,
                divergences=len(divergences),
                replicas=sorted(answers),
            )
            for listener in listeners:
                try:
                    listener(result)
                except Exception:  # noqa: BLE001 - canary must keep flying
                    pass
        return result

    def last_pass_age_s(self) -> Optional[float]:
        """Seconds since the last fully passing cycle — the fleet SLO
        "divergence-probe freshness" reads this. None until the probe
        has passed once (graded as no_data, not a breach: a fleet that
        has not been probed yet is not failing its SLO)."""
        with self._lock:
            if self._last_pass_mono is None:
                return None
            return max(0.0, self._clock() - self._last_pass_mono)

    def export(self) -> dict:
        age = self.last_pass_age_s()
        with self._lock:
            return {
                "name": self._name,
                "indices": list(self._indices),
                "db_size": self._db_size,
                "cycles": self._cycles,
                "divergences": self._divergences,
                "errors": self._errors,
                "last_pass_age_s": (
                    round(age, 3) if age is not None else None
                ),
                "history": [dict(r) for r in self._history],
            }
