"""Cost-aware admission control and per-tenant QoS for serving,
copied from the JAX package's `capacity/admission.py`.

Replaces the serving batcher's fixed `max_queue=256` *count* bound with
a *cost* bound priced by `CapacityModel`:

* **Shed-early** — each candidate request is priced in estimated
  device-ms; if the queue's estimated drain time already exceeds the
  request's deadline, the request is doomed: admitting it would burn
  device time producing a response nobody reads. It is shed at
  admission with a `RetryAfter` hint instead.
* **Per-tenant token buckets** — a tenant's sustained rate is bounded
  by its policy (`rate_qps` keys/second with a `burst` allowance), so a
  misconfigured client cannot consume the whole cost budget before
  fair queuing even gets a say.
* **Weighted-fair queue** — dequeue order across tenants follows
  virtual finish times (start-time fair queuing), so each backlogged
  tenant drains in proportion to its weight. With a single tenant the
  finish tags are monotone in arrival order and the queue degenerates
  to exact FIFO — the pre-QoS behavior.

The controller is workload-agnostic: it prices and meters, the serving
batcher enforces (this package never imports serving).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..observability import events as events_mod
from .model import CapacityModel, WorkCost, default_capacity_model


class ShedReason(enum.Enum):
    """Why admission refused a request (the `RetryAfter` envelope and
    the shed metrics are labeled with this)."""

    QUOTA = "quota"  # tenant token bucket exhausted
    DRAIN_DEADLINE = "drain_deadline"  # doomed: drain estimate > deadline
    QUEUE_COST = "queue_cost"  # global queued-cost budget full
    PRIORITY = "priority"  # brownout floor sheds this tenant's class


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant QoS contract.

    `weight` sets the tenant's fair share of dequeue bandwidth under
    contention; `rate_qps`/`burst` bound its sustained admission rate in
    keys/second (None = unmetered); `priority` orders tenants for the
    brownout ladder — the ladder sheds tenants whose priority falls
    below its floor, so 0 = best-effort, 1 = standard (default),
    2 = critical (survives the `critical_only` step).
    """

    weight: float = 1.0
    rate_qps: Optional[float] = None
    burst: Optional[float] = None
    priority: int = 1

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("weight must be positive")
        if self.rate_qps is not None and self.rate_qps <= 0:
            raise ValueError("rate_qps must be positive")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: Optional[ShedReason] = None
    retry_after_s: float = 0.0
    cost: Optional[WorkCost] = None
    drain_ms: float = 0.0  # estimated queue drain including this request


class TokenBucket:
    """Deterministic token bucket (injectable clock for tests)."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self.rate = rate
        self._base_rate = rate
        self.burst = burst if burst is not None else max(1.0, rate)
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()

    def set_scale(self, scale: float, now: Optional[float] = None) -> None:
        """Scale the refill rate to `scale` x the configured rate
        (predictive governor hook). Refills at the old rate first so
        already-earned tokens are not retroactively repriced."""
        if scale <= 0:
            raise ValueError("scale must be positive")
        now = self._clock() if now is None else now
        self._refill(now)
        self.rate = self._base_rate * scale

    @property
    def base_rate(self) -> float:
        return self._base_rate

    def _refill(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate
        )
        self._stamp = now

    def try_take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def time_until(self, n: float = 1.0, now: Optional[float] = None) -> float:
        """Seconds until `n` tokens will be available (0 if they are)."""
        now = self._clock() if now is None else now
        self._refill(now)
        deficit = n - self._tokens
        return max(0.0, deficit / self.rate)

    @property
    def tokens(self) -> float:
        self._refill(self._clock())
        return self._tokens


class WeightedFairQueue:
    """Start-time fair queuing over opaque items.

    Each pushed item gets a virtual finish tag
    ``start + cost / weight`` where start is
    ``max(queue virtual time, tenant's last finish)``; `pop` returns the
    item with the smallest finish tag (arrival order breaks ties), so
    backlogged tenants drain in proportion to their weights. A single
    tenant's tags are monotone in arrival order: exact FIFO.

    Not thread-safe by itself — the batcher already serializes queue
    access under its condition variable.
    """

    def __init__(self):
        self._per_tenant: Dict[str, deque] = {}
        self._last_finish: Dict[str, float] = {}
        self._vtime = 0.0
        self._seq = 0
        self._len = 0

    def push(
        self,
        item,
        tenant: str = "default",
        weight: float = 1.0,
        cost: float = 1.0,
    ) -> None:
        start = max(self._vtime, self._last_finish.get(tenant, 0.0))
        finish = start + max(cost, 1e-9) / max(weight, 1e-9)
        self._last_finish[tenant] = finish
        self._per_tenant.setdefault(tenant, deque()).append(
            (finish, self._seq, item)
        )
        self._seq += 1
        self._len += 1

    def _head(self) -> Optional[Tuple[str, Tuple[float, int, object]]]:
        best = None
        for tenant, q in self._per_tenant.items():
            if q and (best is None or q[0][:2] < best[1][:2]):
                best = (tenant, q[0])
        return best

    def peek(self):
        head = self._head()
        return head[1][2] if head else None

    def pop(self):
        head = self._head()
        if head is None:
            raise IndexError("pop from empty WeightedFairQueue")
        tenant, (finish, _seq, item) = head
        self._per_tenant[tenant].popleft()
        if not self._per_tenant[tenant]:
            del self._per_tenant[tenant]
        # Advance virtual time so newly-arriving tenants start "now"
        # rather than back-dated to 0 (which would let an idle tenant
        # burst ahead of everyone's backlog).
        self._vtime = max(self._vtime, finish)
        self._len -= 1
        return item

    def drain(self) -> List:
        items = []
        while self._len:
            items.append(self.pop())
        return items

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def backlog_by_tenant(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._per_tenant.items() if q}


class AdmissionController:
    """Prices candidate requests and decides admit-vs-shed.

    The enforcement loop lives in the serving batcher: it calls
    `admit()` before enqueueing (shedding with the returned
    `retry_after_s` on refusal) and `release()` when an admitted
    request leaves the system (served, expired, or failed), keeping the
    outstanding-cost estimate honest.
    """

    def __init__(
        self,
        model: Optional[CapacityModel] = None,
        *,
        queue_budget_ms: float = 250.0,
        metrics=None,
        name: str = "admission",
        clock: Callable[[], float] = time.monotonic,
    ):
        if queue_budget_ms <= 0:
            raise ValueError("queue_budget_ms must be positive")
        self.model = model if model is not None else default_capacity_model()
        self.queue_budget_ms = queue_budget_ms
        self._clock = clock
        self._name = name
        self._lock = threading.Lock()
        self._policies: Dict[str, TenantPolicy] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._outstanding_ms = 0.0
        # Workload pricer: maps num_keys -> WorkCost. Defaults to the
        # model's dense `price_pir_keys`; a sparse session installs
        # `price_sparse_pir_keys` via `set_pricer` so admission charges
        # two inner products per key (see serving/sparse.py).
        self._pricer = None
        self._min_priority = 0  # brownout floor; 0 admits every class
        self._rate_scale = 1.0  # predictive governor multiplier
        self._admitted_by_tenant: Dict[str, int] = {}
        self._shed_by_tenant: Dict[str, int] = {}
        self.metrics = metrics
        if metrics is not None:
            self._c_admitted = metrics.counter(f"{name}.admitted")
            # Same `base{k=v}` convention as serving.metrics.labeled_name
            # (not imported: serving is a restricted layer above us).
            self._c_shed = {
                reason: metrics.counter(
                    f"{name}.shed{{reason={reason.value}}}"
                )
                for reason in ShedReason
            }
            self._g_outstanding = metrics.gauge(f"{name}.outstanding_ms")
            self._g_min_priority = metrics.gauge(f"{name}.min_priority")
            self._g_rate_scale = metrics.gauge(f"{name}.rate_scale")
            self._g_rate_scale.set(1.0)

    # -- tenant policy -------------------------------------------------------

    def set_tenant(self, tenant: str, policy: TenantPolicy) -> None:
        with self._lock:
            self._policies[tenant] = policy
            if policy.rate_qps is not None:
                bucket = TokenBucket(
                    policy.rate_qps, policy.burst, clock=self._clock
                )
                if self._rate_scale != 1.0:
                    bucket.set_scale(self._rate_scale)
                self._buckets[tenant] = bucket
            else:
                self._buckets.pop(tenant, None)

    def policy(self, tenant: str) -> TenantPolicy:
        with self._lock:
            return self._policies.get(tenant) or TenantPolicy()

    def set_pricer(self, pricer) -> None:
        """Install a workload pricer (`num_keys -> WorkCost`); None
        restores the model's dense `price_pir_keys`."""
        with self._lock:
            self._pricer = pricer

    # -- brownout hook -------------------------------------------------------

    def set_min_priority(self, floor: int) -> None:
        """Shed tenants whose policy priority is below `floor` (the
        brownout ladder raises and lowers this)."""
        with self._lock:
            self._min_priority = floor
        if self.metrics is not None:
            self._g_min_priority.set(floor)

    @property
    def min_priority(self) -> int:
        return self._min_priority

    # -- predictive governor hook --------------------------------------------

    def set_rate_scale(self, scale: float) -> None:
        """Scale every tenant bucket's refill to `scale` x its policy
        rate (1.0 = policy as declared). The `PredictiveGovernor`
        tightens this as forecast approaches capacity and restores it
        when the forecast recedes; buckets created later inherit the
        current scale."""
        if scale <= 0:
            raise ValueError("scale must be positive")
        with self._lock:
            self._rate_scale = float(scale)
            for bucket in self._buckets.values():
                bucket.set_scale(self._rate_scale)
        if self.metrics is not None:
            self._g_rate_scale.set(round(self._rate_scale, 4))

    @property
    def rate_scale(self) -> float:
        return self._rate_scale

    # -- the decision --------------------------------------------------------

    def admit(
        self,
        num_keys: int,
        tenant: str = "default",
        deadline: Optional[float] = None,
        now: Optional[float] = None,
    ) -> AdmissionDecision:
        """Price a request of `num_keys` and decide. `deadline` is
        absolute clock seconds (same clock as `clock=`). On admission
        the request's device-ms joins the outstanding estimate — the
        caller MUST `release()` the returned cost when the request
        leaves."""
        now = self._clock() if now is None else now
        with self._lock:
            policy = self._policies.get(tenant) or TenantPolicy()
            if policy.priority < self._min_priority:
                return self._shed(
                    tenant, ShedReason.PRIORITY, retry_after_s=1.0
                )
            bucket = self._buckets.get(tenant)
            if bucket is not None and not bucket.try_take(num_keys, now=now):
                return self._shed(
                    tenant,
                    ShedReason.QUOTA,
                    retry_after_s=bucket.time_until(num_keys, now=now),
                )
            pricer = self._pricer
            cost = (
                pricer(num_keys)
                if pricer is not None
                else self.model.price_pir_keys(num_keys)
            )
            drain_ms = self._outstanding_ms + cost.device_ms
            if deadline is not None and drain_ms > (deadline - now) * 1e3:
                # Doomed: it would expire in queue. Shedding now costs
                # zero device work; retry once the backlog has drained
                # past the point where this request would fit.
                return self._shed(
                    tenant,
                    ShedReason.DRAIN_DEADLINE,
                    retry_after_s=max(
                        1e-3, (drain_ms - max(0.0, (deadline - now) * 1e3))
                        / 1e3,
                    ),
                    cost=cost,
                    drain_ms=drain_ms,
                )
            if drain_ms > self.queue_budget_ms:
                return self._shed(
                    tenant,
                    ShedReason.QUEUE_COST,
                    retry_after_s=max(
                        1e-3, (drain_ms - self.queue_budget_ms) / 1e3
                    ),
                    cost=cost,
                    drain_ms=drain_ms,
                )
            self._outstanding_ms += cost.device_ms
            self._admitted_by_tenant[tenant] = (
                self._admitted_by_tenant.get(tenant, 0) + 1
            )
            if self.metrics is not None:
                self._c_admitted.inc()
                self._g_outstanding.set(round(self._outstanding_ms, 3))
            return AdmissionDecision(
                admitted=True, cost=cost, drain_ms=drain_ms
            )

    def _shed(
        self,
        tenant: str,
        reason: ShedReason,
        retry_after_s: float,
        cost: Optional[WorkCost] = None,
        drain_ms: float = 0.0,
    ) -> AdmissionDecision:
        # Caller holds self._lock.
        self._shed_by_tenant[tenant] = self._shed_by_tenant.get(tenant, 0) + 1
        if self.metrics is not None:
            self._c_shed[reason].inc()
        # Coalesced per tenant+reason: a shed storm is one journal line
        # with a repeat count, not a ring flush.
        events_mod.emit(
            "admission.shed",
            f"{tenant}: {reason.value}",
            severity="warning",
            coalesce_key=f"shed:{tenant}:{reason.value}",
            coalesce_s=5.0,
            tenant=tenant,
            reason=reason.value,
        )
        return AdmissionDecision(
            admitted=False,
            reason=reason,
            retry_after_s=retry_after_s,
            cost=cost,
            drain_ms=drain_ms,
        )

    def release(self, cost: Optional[WorkCost]) -> None:
        """An admitted request left the system (served / expired /
        failed): remove its estimate from the outstanding drain."""
        if cost is None:
            return
        with self._lock:
            self._outstanding_ms = max(
                0.0, self._outstanding_ms - cost.device_ms
            )
            if self.metrics is not None:
                self._g_outstanding.set(round(self._outstanding_ms, 3))

    # -- introspection -------------------------------------------------------

    @property
    def outstanding_ms(self) -> float:
        return self._outstanding_ms

    def export(self) -> dict:
        with self._lock:
            tenants = {}
            for tenant in sorted(
                set(self._policies)
                | set(self._admitted_by_tenant)
                | set(self._shed_by_tenant)
            ):
                policy = self._policies.get(tenant) or TenantPolicy()
                bucket = self._buckets.get(tenant)
                tenants[tenant] = {
                    "weight": policy.weight,
                    "priority": policy.priority,
                    "rate_qps": policy.rate_qps,
                    "effective_rate_qps": (
                        round(bucket.rate, 3) if bucket is not None else None
                    ),
                    "tokens": (
                        round(bucket.tokens, 2) if bucket is not None else None
                    ),
                    "admitted": self._admitted_by_tenant.get(tenant, 0),
                    "shed": self._shed_by_tenant.get(tenant, 0),
                }
            return {
                "queue_budget_ms": self.queue_budget_ms,
                "outstanding_ms": round(self._outstanding_ms, 3),
                "min_priority": self._min_priority,
                "rate_scale": round(self._rate_scale, 4),
                "tenants": tenants,
            }


class PredictiveGovernor:
    """Act-before-burn: tightens tenant token buckets as the forecast
    plane predicts a capacity breach, restores them as it recedes.

    `forecast_source` is a zero-arg callable returning the earliest
    predicted time-to-breach in seconds, or None when nothing inside
    the horizon will breach (duck-typed so this package never imports
    the observability forecaster's types — in practice it is
    `Forecaster.min_time_to_breach_s`). `update()` maps that to a
    refill scale:

        ttb None or >= horizon_s  ->  1.0   (policy as declared)
        ttb -> 0                  ->  linearly down to `floor`

    and applies it via `AdmissionController.set_rate_scale`. The map
    is stateless and monotone, so the revert after a ramp is automatic
    and exact — no hysteresis to get stuck in.
    """

    def __init__(
        self,
        admission: AdmissionController,
        forecast_source: Callable[[], Optional[float]],
        *,
        horizon_s: float = 120.0,
        floor: float = 0.25,
        name: str = "governor",
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if horizon_s <= 0:
            raise ValueError("horizon_s must be positive")
        if not 0 < floor <= 1.0:
            raise ValueError("floor must be in (0, 1]")
        self.admission = admission
        self._forecast_source = forecast_source
        self.horizon_s = float(horizon_s)
        self.floor = float(floor)
        self._name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._updates = 0
        self._tightenings = 0
        self._last_ttb: Optional[float] = None
        self._last_scale = 1.0
        self.metrics = metrics
        if metrics is not None:
            self._g_scale = metrics.gauge(f"{name}.scale")
            self._g_scale.set(1.0)

    def scale_for(self, ttb: Optional[float]) -> float:
        """The stateless ttb -> refill-scale map (see class docstring)."""
        if ttb is None or ttb >= self.horizon_s:
            return 1.0
        return max(self.floor, max(0.0, ttb) / self.horizon_s)

    def update(self, now: Optional[float] = None) -> float:
        """One governor tick: read the forecast, apply the scale.
        Returns the scale applied. A broken forecast source fails open
        (scale 1.0) — prediction must never take down admission."""
        try:
            ttb = self._forecast_source()
        except Exception:  # noqa: BLE001 - fail open
            ttb = None
        scale = self.scale_for(ttb)
        previous = self.admission.rate_scale
        self.admission.set_rate_scale(scale)
        with self._lock:
            self._updates += 1
            if scale < previous:
                self._tightenings += 1
            self._last_ttb = ttb
            self._last_scale = scale
        if self.metrics is not None:
            self._g_scale.set(round(scale, 4))
        if scale != previous:
            events_mod.emit(
                "governor.scale",
                f"{self._name}: scale {scale:.2f} "
                f"(time-to-breach {ttb if ttb is not None else 'none'})",
                severity="info" if scale >= 1.0 else "warning",
                coalesce_key=f"governor.scale:{self._name}",
                coalesce_s=10.0,
                scale=round(scale, 4),
                time_to_breach_s=ttb,
            )
        return scale

    def export(self) -> dict:
        with self._lock:
            return {
                "name": self._name,
                "horizon_s": self.horizon_s,
                "floor": self.floor,
                "scale": round(self._last_scale, 4),
                "time_to_breach_s": (
                    round(self._last_ttb, 3)
                    if self._last_ttb is not None
                    else None
                ),
                "updates": self._updates,
                "tightenings": self._tightenings,
            }
