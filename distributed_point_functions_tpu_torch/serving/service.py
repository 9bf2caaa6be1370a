"""Leader/Helper/Plain serving sessions: the deployed roles.

The port of the JAX package's `serving/service.py`. `pir/server.py`
implements the protocol roles with injected transport and crypto
callbacks; these sessions wrap them into deployable objects:

* every plain evaluation (a plain-role request, the Leader's own share,
  the Helper's decrypted request) routes through one `DynamicBatcher`
  per session via the server's `set_plain_handler` hook, so concurrent
  requests share device steps; the batcher's worker runs them on the
  session's own CUDA stream;
* requests carry **deadlines** (default
  `ServingConfig.request_timeout_ms`), enforced in the batcher queue
  and on the submitting thread;
* the Leader's Helper leg gets a per-attempt **timeout** and bounded
  **exponential-backoff retry** under a **retry budget** (each
  successful leg earns `helper_retry_budget_ratio` tokens, capped at
  `helper_retry_budget_min`, the starting balance; each retry spends
  one); exhausted retries raise `HelperUnavailable`, or, when the
  operator opts in with `allow_degraded`, answer with the Leader's own
  share only (a client cannot unmask a record from it; it is a liveness
  signal);
* a **circuit breaker** (`robustness/breaker.py`) fronts the Helper
  leg: after `breaker_failure_threshold` consecutive failures it opens
  and requests fail fast with `HelperUnavailable`; after
  `breaker_reset_ms` one half-open probe runs the real leg, and its
  success closes the breaker and ends degraded mode;
* the Leader -> Helper wire is a versioned envelope
  (`observability/propagation.py`) carrying the trace id, the Helper's
  phase digest and the snapshot generation; a Helper fed a bare proto
  answers bare, and a Leader whose envelope faults an older Helper
  steps down one version at a time (`leader.wire_downgrades`);
* with snapshots attached (`serving/snapshots.py`) the Leader compares
  the generation its own share bound to with the Helper's echo and
  never combines shares of two generations: it raises
  `SnapshotMismatch` and retries the whole request up to
  `snapshot_retries` times;
* with `admission_enabled`, cost-aware admission
  (`capacity/admission.py`) prices each request and sheds doomed,
  over-quota and below-floor work with `Overloaded` (`retry_after_s`,
  `reason`); tenants (`set_tenant`, `handle_request(tenant=)`) get
  weights, quotas and priorities. The Leader admits a request before its
  Helper leg is sent, so a shed request costs neither party device time;
* `attach_brownout` wires the ladder's steps to this session: admission
  floors (steps 1 and 4), the batch cap (step 2) and the process-wide
  PIR tier floor (step 3);
* the batcher and the Leader's Helper leg report busy time and typed
  bubbles (`helper_rtt`: the round trip's tail not hidden behind the own
  share) into a `UtilizationTracker` (`utilization`, `set_utilization`);
  `attach_workload` feeds a `WorkloadObservatory`; `capacity_accuracy`
  bundles the cost ledger, the shared recalibrator and the model.

The `try` blocks here hand errors on, never answer in their place: an
evaluation's failure (a kernel's launch or build included) reaches the
caller as that exception; only a failed Helper leg, with
`allow_degraded`, is answered, with the Leader's own share; nothing falls
back to a plain version.

Sessions speak library `messages.PirRequest` objects (`handle_request`)
or the framed proto wire format (`handle_wire`, which plugs into
`transport.FramedTcpServer`), through the port's own codec
(`serialization.py`, byte-equal to the JAX package's protobuf).

Every session takes `device` (None: the CUDA card; "cpu" only when the
caller asks). A session's `metrics` hold its own counters, and its
`launches` the kernel launches of its own batches. The device telemetry
(`observability/device.py`) and the phase recorder are process-wide: a
process that wants them in a registry binds one, once, itself, so that
a Leader and a Helper in one process do not take each other's. Not
carried from the JAX package: the mesh wiring (it comes with the port's
multi-device slice), the prober, and the XLA compilation cache (no XLA
runs here). `handle_wire` takes a `tenant`, which the JAX package's
does not: the wire carries none, so a deployment that serves tenants
over TCP listens for each on its own port.
"""

from __future__ import annotations

import contextvars
import dataclasses
import threading
import time
from typing import Optional

from .. import serialization
from ..capacity.admission import AdmissionController, TenantPolicy
from ..capacity.brownout import BrownoutController
from ..capacity.recalibrate import CapacityAccuracy, default_recalibrator
from ..observability import costmodel as costmodel_mod
from ..observability import critical_path, propagation, tracing
from ..observability import events as events_mod
from ..observability import phases as phases_mod
from ..observability.utilization import default_utilization_tracker
from ..ops import cuda_lib
from ..pir import messages
from ..pir.database import DenseDpfPirDatabase
from ..pir.server import DenseDpfPirServer, clear_tier_floor, set_tier_floor
from ..robustness import failpoints
from ..robustness.breaker import CircuitBreaker
from .batcher import DeadlineExceeded, DynamicBatcher, Overloaded
from .metrics import MetricsRegistry
from .snapshots import SnapshotMismatch
from .transport import Transport, TransportError, TransportTimeout

__all__ = [
    "ServingConfig",
    "HelperUnavailable",
    "SnapshotMismatch",
    "PlainSession",
    "LeaderSession",
    "HelperSession",
    "DeadlineExceeded",
    "Overloaded",
    "TenantPolicy",
]


class HelperUnavailable(RuntimeError):
    """The Helper leg failed every attempt (timeouts and/or refusals)."""


@dataclasses.dataclass
class ServingConfig:
    """Operator knobs for a serving session (the JAX package's fields
    whose features the port has).

    `request_timeout_ms=None` disables deadlines. `helper_retries`
    counts retries after the first attempt; backoff doubles from
    `helper_backoff_ms` up to `helper_backoff_max_ms`. The breaker opens
    after `breaker_failure_threshold` consecutive failed legs and admits
    one half-open probe per `breaker_reset_ms`. `helper_digest=False`
    pins the Leader's envelope at v1 (no Helper phase digest, no
    critical-path split). `snapshot_retries` bounds the Leader's re-runs
    of a request whose Helper answered from another generation.

    `admission_enabled` puts cost-aware admission in front of the
    batcher (the queue then holds at most `admission_queue_budget_ms` of
    estimated device-ms); `batching=False` serves every request on its
    own thread without a batcher; `breaker_enabled=False` runs the
    Helper leg without its breaker; `pipeline_depth` is the batcher's (2:
    a completion thread; 1: complete on the worker); `utilization=False`
    detaches the process-wide utilization tracker.
    """

    max_batch_size: int = 64
    max_wait_ms: float = 2.0
    max_queue: int = 256
    request_timeout_ms: Optional[float] = None
    helper_timeout_ms: Optional[float] = 30_000.0
    helper_retries: int = 2
    helper_backoff_ms: float = 10.0
    helper_backoff_max_ms: float = 250.0
    allow_degraded: bool = False
    breaker_failure_threshold: int = 5
    breaker_reset_ms: float = 1000.0
    helper_retry_budget_ratio: float = 0.1
    helper_retry_budget_min: float = 10.0
    helper_digest: bool = True
    snapshot_retries: int = 3
    admission_enabled: bool = False
    admission_queue_budget_ms: float = 250.0
    batching: bool = True
    breaker_enabled: bool = True
    pipeline_depth: int = 2
    utilization: bool = True


# The deadline travels from handle_request into the server's plain
# handler (called on the same thread, possibly inside the Leader's
# while_waiting) without threading it through the server's signatures.
_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "serving_deadline", default=None
)
# The generation the most recent batched evaluation on this context
# bound to: the Helper echoes it, the Leader compares its own against
# the echo. Reset to None at each entry point.
_EVAL_GENERATION: contextvars.ContextVar = contextvars.ContextVar(
    "serving_eval_generation", default=None
)
# The requesting tenant rides the same way, read where the plain
# handler submits to the batcher.
_TENANT: contextvars.ContextVar = contextvars.ContextVar(
    "serving_tenant", default="default"
)
# Keys admitted ahead of the batcher's submit (`_Admitted`): by
# `handle_wire` before it decodes, and by the Leader before its Helper leg.
_ADMITTED: contextvars.ContextVar = contextvars.ContextVar(
    "serving_admitted", default=None
)


class _Admitted:
    """Keys a request was admitted for ahead of its submit, to one
    session's batcher: `top_up` charges admission for the keys it lacks
    (raising `Overloaded` on a shed), the plain handler of that batcher
    `take`s the cost into its submit (an in-process Helper on the same
    thread leaves another batcher's alone), and `release` gives back a
    cost never submitted."""

    __slots__ = ("batcher", "keys", "costs", "taken")

    def __init__(self, batcher: DynamicBatcher):
        self.batcher = batcher
        self.keys = 0
        self.costs = []
        self.taken = False

    def top_up(self, num_keys: int, tenant: str, deadline) -> None:
        if not self.taken and num_keys > self.keys:
            cost = self.batcher.admit(num_keys - self.keys, tenant, deadline)
            self.keys = num_keys
            if cost is not None:
                self.costs.append(cost)

    def take(self, batcher, num_keys: int, tenant: str, deadline):
        """The admitted cost of `num_keys` for `batcher`'s submit, or None
        when the box is another batcher's (or already taken)."""
        if batcher is not self.batcher or self.taken:
            return None
        self.top_up(num_keys, tenant, deadline)
        self.taken = True
        if not self.costs:
            return None
        return dataclasses.replace(
            self.costs[0], device_ms=sum(c.device_ms for c in self.costs),
            quantity=sum(c.quantity for c in self.costs))

    def release(self) -> None:
        if not self.taken:
            self.taken = True
            for cost in self.costs:
                self.batcher.release(cost)


def _admitted_cost(batcher, keys):
    """The cost admitted ahead for this submit (None: admit it there)."""
    box = _ADMITTED.get()
    return (box.take(batcher, len(keys), _TENANT.get(), _DEADLINE.get())
            if box is not None else None)


def evaluated_generation() -> Optional[int]:
    """The snapshot generation the last batched evaluation on this thread
    bound to (None before one, or without snapshots): after a Leader's
    `handle_request` or `handle_wire`, its own share's."""
    return _EVAL_GENERATION.get()


class _Session:
    """Shared session mechanics: batcher wiring, deadlines, wire codec."""

    def __init__(
        self,
        server: DenseDpfPirServer,
        config: Optional[ServingConfig],
        metrics: Optional[MetricsRegistry],
        name: str,
    ):
        self._server = server
        self._config = config if config is not None else ServingConfig()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._name = name
        self.snapshots = None
        # This session's kernel launches, counted on its batch worker.
        self._launches: dict = {}
        # The process-wide cost ledger mirrors into this session's
        # registry; the shared recalibrator corrects the default model.
        ledger = costmodel_mod.default_cost_ledger()
        ledger.bind_registry(self.metrics)
        self.capacity_accuracy = CapacityAccuracy(
            ledger=ledger, recalibrator=default_recalibrator())
        self.admission: Optional[AdmissionController] = None
        if self._config.admission_enabled:
            self.admission = AdmissionController(
                queue_budget_ms=self._config.admission_queue_budget_ms,
                metrics=self.metrics,
                name=f"{name}.admission",
            )
        self._batcher: Optional[DynamicBatcher] = None
        if self._config.batching:
            self._batcher = DynamicBatcher(
                self._evaluate_keys,
                max_batch_size=self._config.max_batch_size,
                max_wait_ms=self._config.max_wait_ms,
                max_queue=self._config.max_queue,
                metrics=self.metrics,
                name=f"{name}.batcher",
                device=server.device,
                admission=self.admission,
                pipeline_depth=self._config.pipeline_depth,
            )
            server.set_plain_handler(self._batched_plain_handler)
        # Where this session's own events go: None is the process
        # journal; a fleet points it at its replica's scoped journal, so
        # that breaker transitions, degraded mode and generation skew
        # carry the replica's identity when N replicas share a process.
        self._session_journal = None
        self._util = None
        if self._config.utilization:
            self.set_utilization(default_utilization_tracker())
        self._workload = None
        self._workload_key_fn = None

    @property
    def server(self) -> DenseDpfPirServer:
        return self._server

    @property
    def config(self) -> ServingConfig:
        return self._config

    @property
    def batcher(self) -> Optional[DynamicBatcher]:
        return self._batcher

    @property
    def launches(self) -> dict:
        """Kernel launches of this session's evaluations so far, by
        kernel (`ops.cuda_lib.LAUNCHES` counts every session's)."""
        return cuda_lib.read_counts(self._launches)

    def attach_snapshots(self, manager):
        """Wire a `SnapshotManager` into the session: generation flips
        land only at this session's batch boundaries, and the wire
        entry points carry and check the generation."""
        self.snapshots = manager
        if self._batcher is not None:
            self._batcher.set_generation_source(manager)
        return manager

    def set_journal(self, journal):
        """Route this session's own events through `journal` (a
        replica-scoped `EventJournal`); None restores the process
        journal. Returns `journal`."""
        self._session_journal = journal
        return journal

    def _emit(self, kind, message, severity="info", **fields):
        journal = (
            self._session_journal
            if self._session_journal is not None
            else events_mod.default_journal()
        )
        try:
            journal.emit(kind, message, severity=severity, **fields)
        except Exception:  # noqa: BLE001 - journaling never breaks serving
            pass

    # -- observation -----------------------------------------------------------

    def attach_workload(self, observatory, key_fn=None):
        """Feed a `WorkloadObservatory` from this session's entry point:
        every `handle_request` observes its key count, tenant and
        deadline headroom. Key indices stay out (the DPF keys hide them
        from this server) unless `key_fn(request) -> indices` supplies
        them where they are public (plain deployments, load generators).
        Returns `observatory`."""
        self._workload = observatory
        self._workload_key_fn = key_fn
        return observatory

    def _observe_workload(self, request, deadline, tenant, now) -> None:
        observatory = self._workload
        if observatory is None:
            return
        plain = request.plain_request
        key_fn = self._workload_key_fn
        observatory.observe(
            num_keys=len(plain.dpf_keys) if plain is not None else 1,
            tenant=tenant,
            key_indices=key_fn(request) if key_fn is not None else None,
            deadline_s=max(0.0, deadline - now) if deadline is not None else None,
            now=now,
        )

    def set_utilization(self, tracker):
        """Report this session's busy time and bubbles into `tracker` (a
        `UtilizationTracker`, mirrored into this session's registry);
        None detaches. Returns `tracker`."""
        self._util = tracker
        if tracker is not None:
            tracker.bind_registry(self.metrics)
        if self._batcher is not None:
            self._batcher.set_utilization(tracker)
        return tracker

    # -- QoS and brownout --------------------------------------------------------

    def set_tenant(self, tenant: str, policy: TenantPolicy) -> None:
        """Register a tenant's QoS contract (needs `admission_enabled`)."""
        if self.admission is None:
            raise RuntimeError("set_tenant requires ServingConfig.admission_enabled")
        self.admission.set_tenant(tenant, policy)

    def attach_brownout(self, brownout: BrownoutController, batch_cap: int = 8,
                        cheap_tier: str = "streaming") -> BrownoutController:
        """Wire the ladder's steps to this session: admission priority
        floors (steps 1 and 4, with admission), the batcher's batch cap
        (step 2) and the process-wide PIR tier floor (step 3). Returns
        `brownout`."""
        if self.admission is not None:
            adm = self.admission
            brownout.add_step_action(
                "shed_low_priority",
                lambda: adm.set_min_priority(1),
                lambda: adm.set_min_priority(0),
            )
            # Reverts run in reverse engage order: critical_only's revert
            # returns the floor to shed_low_priority's.
            brownout.add_step_action(
                "critical_only",
                lambda: adm.set_min_priority(2),
                lambda: adm.set_min_priority(1),
            )
        if self._batcher is not None:
            batcher = self._batcher
            brownout.add_step_action(
                "cap_batches",
                lambda: batcher.set_batch_cap(batch_cap),
                lambda: batcher.set_batch_cap(None),
            )
        brownout.add_step_action(
            "force_cheap_tier",
            lambda: set_tier_floor(cheap_tier),
            clear_tier_floor,
        )
        return brownout

    # -- batching -----------------------------------------------------------

    def _evaluate_keys(self, keys):
        """The batcher's evaluation: one device step for the whole
        coalesced key batch."""
        with cuda_lib.counting_into(self._launches):
            response = self._server.handle_plain_request(
                messages.PirRequest(plain_request=messages.PlainRequest(dpf_keys=keys))
            )
        return response.dpf_pir_response.masked_response

    def _batched_plain_handler(self, request):
        keys = request.plain_request.dpf_keys
        out, generation = self._batcher.submit_ex(
            keys, deadline=_DEADLINE.get(), tenant=_TENANT.get(),
            admitted=_admitted_cost(self._batcher, keys),
        )
        if generation is not None:
            # Read up-stack on this same context (the Helper's echo, the
            # Leader's own-share generation); each entry point resets it.
            _EVAL_GENERATION.set(generation)
        return messages.PirResponse(
            dpf_pir_response=messages.DpfPirResponse(masked_response=list(out))
        )

    # -- request entry points -----------------------------------------------

    def _default_deadline(self) -> Optional[float]:
        if self._config.request_timeout_ms is None:
            return None
        return time.monotonic() + self._config.request_timeout_ms / 1e3

    def handle_request(
        self,
        request: "messages.PirRequest",
        deadline: Optional[float] = None,
        tenant: str = "default",
    ) -> "messages.PirResponse":
        """Serve one request; `deadline` is absolute `time.monotonic()`
        seconds (default from `request_timeout_ms`); `tenant` keys the
        admission policy when admission is enabled."""
        if deadline is None:
            deadline = self._default_deadline()
        self._observe_workload(request, deadline, tenant, time.monotonic())
        token = _DEADLINE.set(deadline)
        tenant_token = _TENANT.set(tenant)
        try:
            with tracing.trace_request(f"{self._name}.request", role=self._name):
                with phases_mod.default_phase_recorder().request(self._name):
                    with self.metrics.timed(f"{self._name}.request_ms"):
                        return self._server.handle_request(request)
        finally:
            _TENANT.reset(tenant_token)
            _DEADLINE.reset(token)

    def handle_wire(self, data: bytes, tenant: str = "default") -> bytes:
        """Framed proto entry point (plugs into `FramedTcpServer`).

        An incoming trace-context envelope (a Leader's Helper leg) is
        unwrapped here: the inner proto serves under the propagated trace
        id and the reply wraps back in the request's envelope version,
        with this side's spans, its phase digest (v2) and the generation
        its share evaluated against (v3). A bare proto (a client, or an
        older Leader) is answered bare. A shed request (`Overloaded`)
        from an enveloped peer answers a typed error envelope with the
        backoff hint; from a bare peer it propagates to the transport.
        `tenant` keys the admission policy (the wire carries none). With
        admission, a request is admitted for one key before it is decoded
        (every request has one), so that a shed costs no decode; a request
        of more keys is charged the rest once decoded (two admissions in
        its tenant's count).
        """
        recv_ms = time.perf_counter() * 1e3
        trace_id, inner, req_version, req_generation = (
            propagation.try_decode_request_ext(data)
        )
        resp_version = min(req_version, propagation.PROPAGATION_VERSION)
        _EVAL_GENERATION.set(None)
        if self.admission is not None and self._batcher is not None:
            deadline = self._default_deadline()
            box = _Admitted(self._batcher)
            try:
                box.top_up(1, tenant, deadline)
            except Overloaded as e:
                if trace_id is None:
                    raise
                self.metrics.counter(f"{self._name}.wire_overloads").inc()
                return propagation.encode_error(
                    "overloaded", message=str(e), retry_after_s=e.retry_after_s,
                    trace_id=trace_id)
            token = _ADMITTED.set(box)
            try:
                return self._serve_wire(inner, trace_id, resp_version, req_generation,
                                        recv_ms, tenant, deadline)
            finally:
                _ADMITTED.reset(token)
                box.release()
        return self._serve_wire(inner, trace_id, resp_version, req_generation, recv_ms,
                                tenant, None)

    def _serve_wire(self, inner, trace_id, resp_version, req_generation, recv_ms,
                    tenant, deadline):
        t0 = time.perf_counter()
        with tracing.trace_request(
            f"{self._name}.request",
            trace_id=trace_id,
            fresh=trace_id is not None,
            role=self._name,
        ) as trace:
            # fresh at the RPC boundary: an in-process transport runs
            # this on the Leader's thread, and the Helper's phases must
            # not merge into the Leader's record.
            with phases_mod.default_phase_recorder().request(
                self._name, fresh=trace_id is not None
            ):
                with tracing.span("decode"), phases_mod.phase("respond"):
                    request = serialization.parse_pir_request(
                        self._server.dpf, inner)
                try:
                    response = self.handle_request(request, deadline, tenant)
                except Overloaded as e:
                    if trace_id is None:
                        raise
                    self.metrics.counter(f"{self._name}.wire_overloads").inc()
                    return propagation.encode_error(
                        "overloaded",
                        message=str(e),
                        retry_after_s=e.retry_after_s,
                        trace_id=trace.trace_id,
                    )
                with tracing.span("encode"), phases_mod.phase("respond"):
                    out = serialization.serialize_pir_response(response)
            if trace_id is None:
                return out
            # The generation this request's share evaluated against,
            # stamped at its batch boundary.
            served_generation = _EVAL_GENERATION.get()
            if (
                req_generation is not None
                and served_generation is not None
                and req_generation != served_generation
            ):
                # Advisory: the Leader's echo check is the enforcement
                # point; the skew is journaled while the window is open.
                self._emit(
                    "snapshot.mismatch",
                    f"request bound generation {req_generation}, "
                    f"evaluated against {served_generation}",
                    severity="warning",
                    party=self._name,
                    request_generation=req_generation,
                    served_generation=served_generation,
                    coalesce_key=(
                        f"snapshot.skew:{self._name}:"
                        f"{req_generation}:{served_generation}"
                    ),
                    coalesce_s=1.0,
                )
            return propagation.encode_response(
                out,
                trace.trace_id,
                server_ms=(time.perf_counter() - t0) * 1e3,
                spans=trace.span_list(),
                version=resp_version,
                phases=trace.attrs.get("phases"),
                recv_ms=recv_ms,
                send_ms=time.perf_counter() * 1e3,
                generation=served_generation,
            )

    def close(self) -> None:
        if self._batcher is not None:
            self._server.set_plain_handler(None)
            self._batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PlainSession(_Session):
    """Single-server (trusted) serving: plain requests, batched.
    `server=` takes a pre-built plain-role server; the default builds a
    dense server over `database` on `device`."""

    def __init__(
        self,
        database: Optional[DenseDpfPirDatabase] = None,
        config: Optional[ServingConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        server=None,
        device=None,
    ):
        if server is None:
            server = DenseDpfPirServer.create_plain(database, device=device)
        super().__init__(server, config, metrics, "plain")


class HelperSession(_Session):
    """The Helper role: decrypts its leg, evaluates (batched), masks."""

    def __init__(
        self,
        database: Optional[DenseDpfPirDatabase] = None,
        decrypter=None,
        config: Optional[ServingConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        server=None,
        device=None,
    ):
        if server is None:
            server = DenseDpfPirServer.create_helper(database, decrypter, device=device)
        super().__init__(server, config, metrics, "helper")


class LeaderSession(_Session):
    """The Leader role: forwards the encrypted Helper leg over an
    injected `Transport` with timeout, retry and backoff, computes its
    own share while waiting, and XORs the masked responses."""

    def __init__(
        self,
        database: Optional[DenseDpfPirDatabase] = None,
        helper_transport: Optional[Transport] = None,
        config: Optional[ServingConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        server=None,
        device=None,
    ):
        self._transport = helper_transport
        if server is None:
            server = DenseDpfPirServer.create_leader(
                database, self._send_to_helper, device=device
            )
        super().__init__(server, config, metrics, "leader")
        m = self.metrics
        self._c_retries = m.counter("leader.helper_retries")
        self._c_timeouts = m.counter("leader.helper_timeouts")
        self._c_failures = m.counter("leader.helper_failures")
        self._c_degraded = m.counter("leader.degraded_responses")
        self._c_downgrades = m.counter("leader.wire_downgrades")
        self._c_mismatches = m.counter("leader.snapshot_mismatches")
        self._c_snapshot_retries = m.counter("leader.snapshot_retries")
        # None: envelope support unknown (probe with one); False: the
        # peer rejected it (bare proto from then on); True: it answered.
        self._peer_envelope: Optional[bool] = None
        # The envelope version ladder: probe at v3, step one version
        # down per non-timeout fault of a probe, then bare proto.
        self._peer_wire_version = (
            propagation.PROPAGATION_VERSION if self._config.helper_digest else 1
        )
        critical_path.install(registry=m)
        self._degraded = False
        self._g_degraded = m.gauge("leader.degraded_mode")
        self._c_degraded_exits = m.counter("leader.degraded_exits")
        self._g_breaker = m.gauge("leader.breaker_state")
        self._c_breaker_opens = m.counter("leader.breaker_opens")
        self._c_fast_fails = m.counter("leader.breaker_fast_fails")
        self._c_helper_overloaded = m.counter("leader.helper_overloaded")
        self._c_budget_exhausted = m.counter("leader.retries_budget_exhausted")
        self._retry_lock = threading.Lock()
        self._retry_tokens = float(self._config.helper_retry_budget_min)
        self._g_retry_tokens = m.gauge("leader.retry_budget_tokens")
        self._g_retry_tokens.set(self._retry_tokens)
        self._breaker: Optional[CircuitBreaker] = None
        if self._config.breaker_enabled:
            self._breaker = CircuitBreaker(
                failure_threshold=self._config.breaker_failure_threshold,
                reset_timeout_ms=self._config.breaker_reset_ms,
                name="leader.helper",
            )
            self._breaker.on_transition(self._on_breaker_transition)

    @property
    def degraded(self) -> bool:
        """Whether the session answers Leader-share-only responses
        (until a half-open probe succeeds)."""
        return self._degraded

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        return self._breaker

    def breaker_export(self) -> Optional[dict]:
        """The Helper leg's breaker state (None without a breaker)."""
        if self._breaker is None:
            return None
        out = self._breaker.export()
        out["degraded_mode"] = self._degraded
        return out

    def _on_breaker_transition(self, old: str, new: str) -> None:
        self._g_breaker.set(float(self._breaker.state_code()))
        self._emit(
            "breaker.transition",
            f"helper-leg breaker {old} -> {new}",
            severity="error" if new == "open" else "info",
            old=old,
            new=new,
        )
        if new == "open":
            self._c_breaker_opens.inc()
        if new == "closed" and self._degraded:
            self._degraded = False
            self._g_degraded.set(0.0)
            self._c_degraded_exits.inc()

    # -- helper leg ---------------------------------------------------------

    def _retry_budget_take(self) -> bool:
        """Spend one retry token; False: the budget is exhausted."""
        with self._retry_lock:
            if self._retry_tokens >= 1.0:
                self._retry_tokens -= 1.0
                self._g_retry_tokens.set(round(self._retry_tokens, 3))
                return True
            return False

    def _retry_budget_earn(self) -> None:
        cfg = self._config
        with self._retry_lock:
            self._retry_tokens = min(
                float(cfg.helper_retry_budget_min),
                self._retry_tokens + cfg.helper_retry_budget_ratio,
            )
            self._g_retry_tokens.set(round(self._retry_tokens, 3))

    def _send_to_helper(self, helper_request, while_waiting):
        """The server's sender with retry: serialize, round-trip with a
        per-attempt timeout, back off and retry on transport faults.
        `while_waiting` (the Leader's own share) runs exactly once,
        overlapped with the first send that reaches the wire. Timeouts
        never step the envelope version down: a slow Helper is not an
        old one."""
        _EVAL_GENERATION.set(None)
        breaker = self._breaker
        if breaker is not None and not breaker.allow():
            self._c_fast_fails.inc()
            raise HelperUnavailable("helper circuit breaker is open (fast-fail)")
        wire = serialization.serialize_pir_request(self._server.dpf, helper_request)
        cfg = self._config
        called = [False]
        # The own share's window (perf_counter ms), subtracted from the
        # round trip where they overlap, and the generation it bound to,
        # captured when it returns (an in-process Helper runs on this
        # thread and would overwrite _EVAL_GENERATION with its own).
        share_window = [None]
        own_gen_box = [None]
        share_failed = [False]

        def leader_share_once():
            if not called[0]:
                called[0] = True
                s0 = time.perf_counter()
                try:
                    with tracing.span("leader_own_share"):
                        while_waiting()
                except BaseException:
                    share_failed[0] = True
                    raise
                finally:
                    share_window[0] = (s0 * 1e3, time.perf_counter() * 1e3)
                    own_gen_box[0] = _EVAL_GENERATION.get()

        timeout = None if cfg.helper_timeout_ms is None else cfg.helper_timeout_ms / 1e3
        backoff = cfg.helper_backoff_ms / 1e3
        trace = tracing.current_trace()
        last: Optional[Exception] = None
        attempt = 0
        while attempt <= cfg.helper_retries:
            enveloped = self._peer_envelope is not False
            payload = (
                propagation.encode_request(
                    trace.trace_id if trace is not None else tracing.new_trace_id(),
                    wire,
                    version=self._peer_wire_version,
                    # Advisory: the serving generation at send time.
                    generation=(
                        self.snapshots.serving_generation()
                        if self.snapshots is not None else None
                    ),
                )
                if enveloped
                else wire
            )
            # A transport's failure is retried, and a probe's fault steps
            # the envelope down; the Leader's own share's error, and any
            # other, propagates as itself.
            try:
                failpoints.fire("service.helper_leg", error=TransportTimeout)
                t0 = time.perf_counter()
                with self.metrics.timed("leader.helper_leg_ms"):
                    data = self._transport.roundtrip(
                        payload, timeout=timeout, on_sent=leader_share_once,
                    )
                rtt_ms = (time.perf_counter() - t0) * 1e3
                if breaker is not None:
                    breaker.record_success()
                self._retry_budget_earn()
                break
            except Exception as e:  # noqa: BLE001 - triaged below
                if share_failed[0]:
                    raise
                if (
                    enveloped
                    and self._peer_envelope is None
                    and not isinstance(e, TransportTimeout)
                ):
                    # A probe's fault, plausibly an old peer choking on
                    # the envelope: one version down, resent at once;
                    # no retry spent, nothing fed to the breaker.
                    if self._peer_wire_version > 1:
                        self._peer_wire_version -= 1
                    else:
                        self._peer_envelope = False
                    self._c_downgrades.inc()
                    last = e
                    continue
                if not isinstance(e, TransportError):
                    raise
                if breaker is not None:
                    breaker.record_failure()
                last = e
                if isinstance(e, TransportTimeout):
                    self._c_timeouts.inc()
                if attempt >= cfg.helper_retries:
                    self._c_failures.inc()
                    raise HelperUnavailable(
                        f"helper leg failed after {attempt + 1} attempt(s): {e}"
                    ) from e
                if not self._retry_budget_take():
                    self._c_budget_exhausted.inc()
                    self._c_failures.inc()
                    raise HelperUnavailable(
                        f"helper retry budget exhausted after "
                        f"{attempt + 1} attempt(s): {e}"
                    ) from e
                self._c_retries.inc()
                time.sleep(min(backoff, cfg.helper_backoff_max_ms / 1e3))
                backoff *= 2
                attempt += 1
        else:
            self._c_failures.inc()
            raise HelperUnavailable(
                f"helper leg failed after {attempt} attempt(s): {last}"
            ) from last
        # A fast Helper could answer before the share ran.
        leader_share_once()
        phases_mod.record("helper_rtt", rtt_ms)
        if self._util is not None:
            # Only the round trip's tail after the own share ended is a
            # barrier: the Leader waited on the Helper alone.
            win = share_window[0]
            exposed_ms = rtt_ms if win is None else max(0.0, t0 * 1e3 + rtt_ms - win[1])
            self._util.record_idle("helper_rtt", exposed_ms / 1e3, thread="leader")
        try:
            meta, inner = (
                propagation.try_decode_response(data) if enveloped else (None, data)
            )
        except propagation.WireErrorResponse as e:
            # A typed refusal from a live, envelope-speaking peer.
            self._peer_envelope = True
            if e.error_type == "overloaded":
                self._c_helper_overloaded.inc()
                raise Overloaded(
                    f"helper shed the request: {e}",
                    retry_after_s=e.retry_after_s,
                    reason="helper_overloaded",
                ) from e
            raise
        if enveloped:
            self._peer_envelope = meta is not None
        if self.snapshots is not None:
            # The generation handshake: the generation the Leader's share
            # bound to against the Helper's echo of its own.
            own_generation = own_gen_box[0]
            helper_generation = meta.get("generation") if meta is not None else None
            if helper_generation is None:
                if own_generation is not None:
                    self.snapshots.note_unchecked(
                        self._peer_wire_version if self._peer_envelope else 0
                    )
            elif own_generation is not None and own_generation != helper_generation:
                self._c_mismatches.inc()
                self.snapshots.record_mismatch(
                    own_generation, helper_generation,
                    trace_id=trace.trace_id if trace is not None else None,
                )
                raise SnapshotMismatch(own_generation, helper_generation)
        if meta is not None:
            self._attribute_helper_leg(meta, t0, rtt_ms, share_window[0], trace)
        elif trace is not None:
            trace.add_span("helper_leg", rtt_ms)
        with tracing.span("decode"):
            return serialization.parse_pir_response(inner)

    def _attribute_helper_leg(self, meta, t0, rtt_ms, win, trace) -> None:
        """Split the Helper leg's round trip: the Helper's own server
        time, the network, and (v2) the skew-corrected net / queue /
        compute decomposition; graft the Helper's spans onto the trace."""
        remote_ms = float(meta.get("server_ms", 0.0))
        network_ms = max(0.0, rtt_ms - remote_ms)
        self.metrics.histogram("leader.helper_remote_ms").observe(remote_ms)
        self.metrics.histogram("leader.helper_network_ms").observe(network_ms)
        skew = None
        t0_ms, t3_ms = t0 * 1e3, t0 * 1e3 + rtt_ms
        if meta.get("recv_ms") is not None and meta.get("send_ms") is not None:
            overlap_ms = (
                max(0.0, min(win[1], t3_ms) - max(win[0], t0_ms))
                if win is not None else 0.0
            )
            skew = critical_path.estimate_skew(
                t0_ms, t3_ms, float(meta["recv_ms"]), float(meta["send_ms"]),
                overlap_ms=overlap_ms,
            )
            decomp = critical_path.decompose_helper_leg(skew, meta.get("phases"))
            if decomp is not None:
                phases_mod.record("helper_net", decomp["helper_net_ms"])
                phases_mod.record("helper_queue", decomp["helper_queue_ms"])
                phases_mod.record("helper_compute", decomp["helper_compute_ms"])
            req = phases_mod.current_request()
            if req is not None:
                req.set_meta("helper_leg", {
                    "rtt_ms": rtt_ms,
                    "own_ms": win[1] - win[0] if win is not None else 0.0,
                    "skew": skew.as_dict(),
                    "decomp": decomp,
                    "helper_phases": meta.get("phases") or {},
                })
        if trace is not None:
            extra = {}
            base_offset_ms = None
            if skew is not None:
                extra["offset_ms_est"] = round(skew.offset_ms, 3)
                extra["offset_uncertainty_ms"] = round(skew.uncertainty_ms, 3)
                trace_start_ms = time.perf_counter() * 1e3 - trace.elapsed_ms()
                base_offset_ms = (
                    float(meta["recv_ms"]) - skew.offset_ms - trace_start_ms
                )
            trace.add_span(
                "helper_leg", rtt_ms, remote_ms=round(remote_ms, 3),
                network_ms=round(network_ms, 3), **extra,
            )
            trace.add_remote_spans(
                meta.get("spans", []), prefix="helper.",
                base_offset_ms=base_offset_ms,
            )
            trace.add_span("helper_network", network_ms)

    # -- degradation --------------------------------------------------------

    def handle_request(self, request, deadline=None, tenant="default"):
        if deadline is None:
            deadline = self._default_deadline()
        retries = max(0, self._config.snapshot_retries)
        attempt = 0
        while True:
            try:
                return self._handle_request_once(request, deadline, tenant)
            except SnapshotMismatch:
                # The whole request again: the own share re-binds once
                # this party's pending flip lands at a batch boundary.
                if attempt >= retries:
                    raise
                attempt += 1
                self._c_snapshot_retries.inc()
                time.sleep(0.002 * attempt)

    def _handle_request_once(self, request, deadline, tenant):
        # Admission before the Helper leg is sent: a shed request costs
        # neither party device time. The own share's submit takes the
        # admitted cost; a cost never submitted (the leg failed first)
        # goes back. A box `handle_wire` opened is topped up, and it
        # releases it.
        if self._batcher is None or request.leader_request is None:
            return self._serve_once(request, deadline, tenant)
        num_keys = len(request.leader_request.plain_request.dpf_keys)
        box = _ADMITTED.get()
        if box is not None and box.batcher is self._batcher and not box.taken:
            box.top_up(num_keys, tenant, deadline)
            return self._serve_once(request, deadline, tenant)
        box = _Admitted(self._batcher)
        box.top_up(num_keys, tenant, deadline)
        token = _ADMITTED.set(box)
        try:
            return self._serve_once(request, deadline, tenant)
        finally:
            _ADMITTED.reset(token)
            box.release()

    def _serve_once(self, request, deadline, tenant):
        try:
            return super().handle_request(request, deadline, tenant)
        except HelperUnavailable:
            if not (self._config.allow_degraded and request.leader_request is not None):
                raise
            # Operator-sanctioned degraded mode: the Leader's own share
            # only, until the breaker's half-open probe succeeds.
            self._c_degraded.inc()
            if not self._degraded:
                self._degraded = True
                self._g_degraded.set(1.0)
                self._emit(
                    "service.degraded",
                    "helper unavailable; serving leader-share-only",
                    severity="error",
                )
            token = _DEADLINE.set(deadline)
            try:
                return self._server._dispatch_plain(
                    messages.PirRequest(
                        plain_request=request.leader_request.plain_request
                    )
                )
            finally:
                _DEADLINE.reset(token)

    def close(self):
        super().close()
        self._transport.close()
