"""Thread-safe dynamic batcher: coalesce concurrent PIR requests.

The port of the JAX package's `serving/batcher.py`. A batch's device
step costs little more for 64 keys than for one, so concurrent requests
share it:

* Concurrent `submit(keys)` calls coalesce into one evaluation of their
  concatenated keys. A batch closes when it holds `max_batch_size` keys
  or `max_wait_ms` after its first request arrived, whichever is first.
* The batch's key count pads up to a **power-of-two bucket** (copies of
  the first key; their results are discarded), so the serving path sees
  at most `log2(max_batch_size) + 1` shapes: the planner's plans, the
  cached block maps and the caching allocator's blocks are reused.
* Admission is a **bounded queue**: with `max_queue` requests already
  waiting, `submit` sheds the request with `Overloaded` instead of
  growing the backlog. With an `AdmissionController`
  (`capacity/admission.py`) attached, the count bound is a backstop
  behind cost-aware admission: each request is priced in estimated
  device-ms, doomed work (drain estimate past the deadline), over-quota
  tenants and tenants below the brownout floor are shed at admission
  with a `retry_after_s` hint and a `reason` on the `Overloaded`, and
  the queue dequeues across tenants in weighted-fair order (without
  admission every request is the default tenant's: FIFO). An admitted
  request's cost is released when it leaves: served, expired or failed.
* Requests carry an optional absolute **deadline** (`time.monotonic()`
  seconds). The worker drops requests that expired while the batch was
  forming before any device work (they fail with `DeadlineExceeded`; a
  bucket of only expired requests is not evaluated), and the submitting
  thread enforces the same deadline on its wait.
* The worker thread runs every evaluation on the batcher's own CUDA
  stream (`device` a CUDA device), so two sessions in one process, a
  Leader and a Helper, queue their kernels on separate streams. A
  batch's evaluation ends with its result copied to the host, which
  synchronizes that stream.
* With `pipeline_depth >= 2` (the sessions' default, 2) the batches are
  pipelined: a completion thread fans out bucket N-1 (results, spans
  and phases, `end_batch`, the cost-ledger feed) while the worker
  dispatches bucket N; depth 1 completes each bucket on the worker. The generation is bound at dispatch by the
  worker, so snapshot flips land only at batch boundaries, and a
  bucket's `end_batch` fires only after its last response fans out,
  which is after its result reached the host: a retired generation's
  staging is never freed under a batch that reads it.

* Brownout's `cap_batches` step caps the batch size (`set_batch_cap`).
* Utilization (`set_utilization`): a batch's busy time is its span on
  the batcher's CUDA stream, between two events recorded around the
  evaluation and read by the completion thread once the result reached
  the host (on the CPU, the evaluation's wall time); the evaluation's
  host time outside that span (key staging before the first kernel) is
  a `staging_sync` bubble, and the worker's waits are `empty_queue`
  (`admission_shed` while requests were shed), `batch_wait` and
  `pipeline_full` bubbles.
* Each completed batch feeds the cost ledger
  (`observability/costmodel.py`) one pair: the capacity model's price of
  the executed bucket (`set_cost_model`: the workload and its pricer)
  and the measured device ms (the stream span; on the CPU the
  evaluation's wall time), keyed by the tier that ran.

An evaluation's error reaches every request of its batch as that
exception: the batcher never answers in its place.

Not carried from the JAX package: the mesh's key multiples (they come
with the port's multi-device slice).

The batcher is generic over the evaluation function
(`evaluate(keys) -> list of per-key results`), so it serves any of the
server roles, and its tests run it on stubs.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import torch

from ..capacity.admission import AdmissionController, WeightedFairQueue
from ..capacity.model import default_capacity_model
from ..observability import costmodel as costmodel_mod
from ..observability import phases as phases_mod
from ..observability import tracing
from ..observability.device import default_telemetry, shape_key
from ..robustness import failpoints
from .metrics import MetricsRegistry


class Overloaded(RuntimeError):
    """The request was shed at admission, not enqueued. `retry_after_s`
    is the server's backoff hint (0 = none given) and `reason` a short
    cause: the admission `ShedReason` value when cost-aware admission
    made the call."""

    def __init__(
        self,
        message: str = "",
        retry_after_s: float = 0.0,
        reason: Optional[str] = None,
    ):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its batch was evaluated."""


def bucket_size(num_keys: int) -> int:
    """Smallest power of two >= num_keys (the batch shape bucket)."""
    if num_keys <= 0:
        raise ValueError("num_keys must be positive")
    return 1 << (num_keys - 1).bit_length()


class _Pending:
    __slots__ = (
        "keys", "deadline", "event", "result", "error", "t0", "abandoned",
        "trace", "phases", "tenant", "cost", "generation",
    )

    def __init__(self, keys, deadline, tenant="default", cost=None):
        self.keys = keys
        self.deadline = deadline
        self.tenant = tenant
        self.cost = cost  # the admission WorkCost, released on completion
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.monotonic()
        self.abandoned = False
        # Snapshot generation the batch evaluated against (None without
        # a generation source), stamped by the worker at the boundary.
        self.generation: Optional[int] = None
        # The submitting request's trace and phase record: the worker
        # and completion threads append onto them by reference.
        self.trace = tracing.current_trace()
        self.phases = phases_mod.current_request()


class _BatchResult:
    """One evaluated bucket between the worker's dispatch half and the
    completion half, captured at dispatch."""

    __slots__ = (
        "live", "results", "error", "collected", "eval_ms", "assembly_s",
        "bucket", "flat_len", "pad_waste", "generation", "gate_t",
        "batch_phases", "events", "transfer_bytes",
    )

    def __init__(self):
        self.results = None
        self.error = None
        self.collected = {}
        self.eval_ms = 0.0
        self.batch_phases = None
        # (start, end) CUDA events around the evaluation on the stream.
        self.events = None
        self.transfer_bytes = 0


class DynamicBatcher:
    """See module docstring. One background worker forms and evaluates
    batches and, at `pipeline_depth >= 2`, a completion thread fans them
    out; `submit` blocks the calling thread until its slice of the batch
    result is ready, or raises `Overloaded` / `DeadlineExceeded` / the
    evaluation's error. `device`: a CUDA device gives the worker its own
    stream; None or the CPU runs on the thread's current stream."""

    def __init__(
        self,
        evaluate: Callable[[List], List],
        *,
        max_batch_size: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int = 256,
        metrics: Optional[MetricsRegistry] = None,
        name: str = "batcher",
        device=None,
        admission: Optional[AdmissionController] = None,
        pipeline_depth: int = 2,
    ):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._evaluate = evaluate
        self._max_batch_size = max_batch_size
        self._batch_cap: Optional[int] = None  # brownout step 2
        self._admission = admission
        self._max_wait_s = max(0.0, max_wait_ms) / 1e3
        self._max_queue = max_queue
        self._name = name
        device = None if device is None else torch.device(device)
        self._stream = (
            torch.cuda.Stream(device)
            if device is not None and device.type == "cuda" else None
        )
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m, n = self.metrics, name
        self._c_submitted = m.counter(f"{n}.requests_submitted")
        self._c_shed = m.counter(f"{n}.requests_shed")
        self._c_deadline = m.counter(f"{n}.requests_deadline_exceeded")
        self._c_batches = m.counter(f"{n}.batches")
        self._c_pad = m.counter(f"{n}.padded_keys")
        self._g_depth = m.gauge(f"{n}.queue_depth")
        self._h_batch = m.histogram(
            f"{n}.batch_keys", buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)
        )
        self._h_latency = m.histogram(f"{n}.request_latency_ms")
        self._h_queue_wait = m.histogram(f"{n}.queue_wait_ms")
        self._h_pad_waste = m.histogram(
            f"{n}.pad_waste_ratio",
            buckets=(0.0, 0.05, 0.1, 0.25, 0.5, 0.75, 0.875, 1.0),
        )
        self._c_expired_in_batch = m.counter(f"{n}.expired_in_batch")
        self._c_batches_skipped = m.counter(f"{n}.batches_skipped_dead")
        # Collected phase brackets that exceeded the measured wall time:
        # `dispatch` clamps at zero and the excess lands here.
        self._c_slop = m.counter(f"{n}.attribution_slop_ms")
        # Each batch's device ms: its span on the stream (the CPU: wall).
        self._h_device = m.histogram(f"{n}.device_ms")
        m.gauge(f"{n}.pipeline_depth").set(float(pipeline_depth))
        self._cond = threading.Condition()
        # Weighted-fair across tenants; one tenant's order is arrival
        # order (exact FIFO), so without admission it is a FIFO queue.
        self._queue = WeightedFairQueue()
        # Utilization hook (`set_utilization`); None: no accounting.
        self._util = None
        # The cost ledger's workload and bucket pricer (`set_cost_model`).
        self._cost_workload = "pir"
        self._cost_pricer = None
        # Snapshot rotation hook (`serving/snapshots.py`): begin_batch()
        # and end_batch() around every evaluation.
        self._generation_source = None
        self._closed = False
        # The pipeline's handoff: at most one evaluated bucket waits for
        # the completion thread.
        self._pipeline_depth = int(pipeline_depth)
        self._complete_q: deque = deque()
        self._complete_cond = threading.Condition()
        self._worker_done = False
        self._completer: Optional[threading.Thread] = None
        if self._pipeline_depth > 1:
            self._completer = threading.Thread(
                target=self._complete_loop, daemon=True, name=f"{name}-completer"
            )
            self._completer.start()
        self._worker = threading.Thread(
            target=self._run, daemon=True, name=f"{name}-worker"
        )
        self._worker.start()

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The worker's CUDA stream (None off the card)."""
        return self._stream

    # -- client side --------------------------------------------------------

    def submit(self, keys: Sequence, deadline: Optional[float] = None,
               tenant: str = "default") -> List:
        """Evaluate `keys` as part of a coalesced batch; returns one
        result per key, in order. `deadline` is absolute
        `time.monotonic()` seconds; `tenant` keys the QoS policy under
        cost-aware admission (ignored without it)."""
        results, _ = self.submit_ex(keys, deadline, tenant)
        return results

    def submit_ex(self, keys: Sequence, deadline: Optional[float] = None,
                  tenant: str = "default", admitted=None):
        """`submit`, returning `(results, generation)`: the snapshot
        generation the batch evaluated against (None without a
        generation source). `admitted` is a cost `admit` already charged
        for this request (the Leader admits before its Helper leg); the
        batcher then does not admit it again and releases that cost."""
        keys = list(keys)
        if not keys:
            raise ValueError("keys must not be empty")
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._queue) >= self._max_queue:
                # The count bound: the whole admission without a
                # controller, a backstop behind one.
                self._c_shed.inc()
                if admitted is not None:
                    self._admission.release(admitted)
                raise Overloaded(
                    f"{self._name}: admission queue full "
                    f"({self._max_queue} requests waiting)",
                    reason="queue_full",
                )
            cost = admitted
            if self._admission is not None and cost is None:
                cost = self._admit_locked(len(keys), tenant, deadline)
            pending = _Pending(keys, deadline, tenant=tenant, cost=cost)
            weight = 1.0 if self._admission is None else self._admission.policy(tenant).weight
            self._queue.push(pending, tenant=tenant, weight=weight, cost=float(len(keys)))
            self._g_depth.set(len(self._queue))
            self._c_submitted.inc()
            self._cond.notify()
        timeout = (
            None if deadline is None
            else max(0.0, deadline - time.monotonic())
        )
        if not pending.event.wait(timeout):
            with self._cond:
                pending.abandoned = True
            # The worker may complete it concurrently; the deadline wins.
            if not pending.event.is_set() or pending.error is not None:
                self._c_deadline.inc()
                raise DeadlineExceeded(
                    f"{self._name}: deadline passed after "
                    f"{(time.monotonic() - pending.t0) * 1e3:.1f} ms in queue"
                )
        if pending.error is not None:
            raise pending.error
        return pending.result, pending.generation

    def admit(self, num_keys: int, tenant: str = "default",
              deadline: Optional[float] = None):
        """Charge a request of `num_keys` to cost-aware admission before
        it reaches `submit_ex` (None without a controller): its cost, to
        pass as `submit_ex(..., admitted=cost)`, or `Overloaded` with the
        shed's hint and reason. A caller that never submits it gives it
        back with `release`."""
        if self._admission is None:
            return None
        with self._cond:
            return self._admit_locked(num_keys, tenant, deadline)

    def _admit_locked(self, num_keys: int, tenant: str, deadline):
        decision = self._admission.admit(num_keys, tenant=tenant, deadline=deadline)
        if not decision.admitted:
            self._c_shed.inc()
            raise Overloaded(
                f"{self._name}: shed at admission ({decision.reason.value}); "
                f"retry after {decision.retry_after_s:.3f}s",
                retry_after_s=decision.retry_after_s,
                reason=decision.reason.value,
            )
        return decision.cost

    def release(self, cost) -> None:
        """Give an admitted cost back to the admission drain model."""
        if self._admission is not None:
            self._admission.release(cost)

    def _release(self, pending: _Pending) -> None:
        self.release(pending.cost)

    # -- snapshot rotation hook ---------------------------------------------

    def set_generation_source(self, source) -> None:
        """Attach a `SnapshotManager` (duck-typed: `begin_batch()`
        returning the bound generation, `end_batch(generation)` when the
        batch retires). Flips then land only between batches."""
        with self._cond:
            self._generation_source = source

    def _end_batch(self, generation) -> None:
        source = self._generation_source
        if generation is not None and source is not None:
            source.end_batch(generation)

    # -- utilization, cost-model and brownout hooks --------------------------

    def set_utilization(self, tracker) -> None:
        """Attach a `UtilizationTracker` (duck-typed: `record_busy(seconds,
        thread=)`, `record_idle(cause, seconds, thread=)`); None detaches.
        See the module docstring for what is busy and what each bubble is."""
        with self._cond:
            self._util = tracker

    def _util_busy(self, seconds: float, thread: str = "worker") -> None:
        util = self._util
        if util is not None and seconds > 0.0:
            util.record_busy(seconds, thread=thread)

    def _util_idle(self, cause: str, seconds: float, thread: str = "worker") -> None:
        util = self._util
        if util is not None and seconds > 0.0:
            util.record_idle(cause, seconds, thread=thread)

    def set_cost_model(self, workload: str, pricer=None) -> None:
        """Key the terminal batches' cost-ledger pairs by `workload`
        ("pir" for dense sessions, "sparse" for sparse ones), each priced
        by `pricer(bucket) -> WorkCost` (default: the process-wide
        model's `price_pir_keys`)."""
        if not workload:
            raise ValueError("workload must be non-empty")
        with self._cond:
            self._cost_workload = str(workload)
            self._cost_pricer = pricer

    def set_batch_cap(self, cap: Optional[int]) -> None:
        """Cap the batch size below `max_batch_size` (brownout's
        `cap_batches` step); None clears."""
        if cap is not None and cap < 1:
            raise ValueError("batch cap must be >= 1 (or None)")
        with self._cond:
            self._batch_cap = cap

    @property
    def batch_cap(self) -> Optional[int]:
        return self._batch_cap

    # -- worker -------------------------------------------------------------

    def _collect(self):
        """Block for the first request, then fill the batch until
        `max_batch_size` keys (or the brownout cap) or `max_wait_ms`
        elapse. Returns (batch, assembly seconds), or None at shutdown
        with an empty queue."""
        empty_s = form_s = 0.0
        shed_before = self._c_shed.value
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                t_wait = time.monotonic()
                self._cond.wait()
                empty_s += time.monotonic() - t_wait
            t_first = time.monotonic()
            batch = [self._queue.pop()]
            num_keys = len(batch[0].keys)
            max_batch = self._max_batch_size
            if self._batch_cap is not None:
                max_batch = min(max_batch, self._batch_cap)
            close_at = t_first + self._max_wait_s
            while num_keys < max_batch:
                if self._queue:
                    nxt = self._queue.peek()
                    if num_keys + len(nxt.keys) > max_batch:
                        break
                    batch.append(self._queue.pop())
                    num_keys += len(nxt.keys)
                    continue
                remaining = close_at - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                t_wait = time.monotonic()
                self._cond.wait(remaining)
                form_s += time.monotonic() - t_wait
            self._g_depth.set(len(self._queue))
        # An empty-queue wait while admission shed requests is idle the
        # policy made, not absent demand.
        self._util_idle("admission_shed" if self._c_shed.value > shed_before
                        else "empty_queue", empty_s)
        self._util_idle("batch_wait", form_s)
        return batch, time.monotonic() - t_first

    def _run(self) -> None:
        stream = (
            torch.cuda.stream(self._stream)
            if self._stream is not None else contextlib.nullcontext()
        )
        try:
            with stream:
                self._run_loop()
        finally:
            # Let the completion thread exit once its queue drains, however
            # the worker stopped.
            with self._complete_cond:
                self._worker_done = True
                self._complete_cond.notify_all()

    def _run_loop(self) -> None:
        while True:
            collected = self._collect()
            if collected is None:
                return
            batch, assembly_s = collected
            # Requests that expired while the batch formed are dropped
            # here, before any device work.
            now = time.monotonic()
            live = []
            for p in batch:
                if p.abandoned or (p.deadline is not None and now > p.deadline):
                    self._c_expired_in_batch.inc()
                    self._release(p)
                    p.error = DeadlineExceeded("expired in queue")
                    p.event.set()
                    continue
                live.append(p)
            if not live:
                self._c_batches_skipped.inc()
                continue
            flat = [k for p in live for k in p.keys]
            bucket = bucket_size(len(flat))
            padded = flat + [flat[0]] * (bucket - len(flat))
            pad_waste = (bucket - len(flat)) / bucket
            self._c_batches.inc()
            self.metrics.counter(
                f"{self._name}.bucket_batches", labels={"bucket": bucket}
            ).inc()
            self._c_pad.inc(bucket - len(flat))
            self._h_batch.observe(len(flat))
            self._h_pad_waste.observe(pad_waste)
            record = _BatchResult()
            record.live = live
            record.assembly_s = assembly_s
            record.bucket = bucket
            record.flat_len = len(flat)
            record.pad_waste = pad_waste
            record.generation = None
            record.gate_t = now
            # Every error of the evaluation goes to each live request of
            # the batch as itself; nothing answers in its place.
            try:
                # Batch boundary: a pending snapshot flip applies here,
                # then the whole bucket binds to one generation.
                source = self._generation_source
                if source is not None:
                    record.generation = source.begin_batch()
                for p in live:
                    p.generation = record.generation
                failpoints.fire("batcher.evaluate")
                telemetry = default_telemetry()
                h2d_before = telemetry.transfers.export()["totals"]["h2d_bytes"]
                tracker = telemetry.compile_tracker
                recorder = phases_mod.default_phase_recorder()
                t_eval = time.perf_counter()
                if self._stream is not None:
                    record.events = (torch.cuda.Event(enable_timing=True),
                                     torch.cuda.Event(enable_timing=True))
                    record.events[0].record()
                with self.metrics.timed(f"{self._name}.evaluate_ms"), \
                        tracker.dispatch(
                            f"{self._name}.evaluate",
                            shape_key(("k", bucket)),
                        ), \
                        recorder.collect() as batch_phases:
                    results = list(self._evaluate(padded))
                if record.events is not None:
                    record.events[1].record()
                record.eval_ms = (time.perf_counter() - t_eval) * 1e3
                record.results = results
                record.collected = (
                    batch_phases.snapshot() if batch_phases is not None else {}
                )
                record.batch_phases = batch_phases
                record.transfer_bytes = max(0, telemetry.transfers.export()[
                    "totals"]["h2d_bytes"] - h2d_before)
                if len(results) < len(flat):
                    raise RuntimeError(
                        f"evaluate returned {len(results)} results for "
                        f"{len(flat)} keys"
                    )
            except Exception as e:  # noqa: BLE001 - handed to every request
                record.error = e
            self._dispatch_complete(record)

    # -- completion half ----------------------------------------------------

    def _dispatch_complete(self, record: _BatchResult) -> None:
        """Hand an evaluated bucket to the completion half: inline at
        depth 1, else through the handoff queue of `pipeline_depth - 1`
        slots (the worker waits while it is full: a `pipeline_full`
        bubble)."""
        if self._completer is None:
            self._complete_one(record)
            return
        waited_s = 0.0
        with self._complete_cond:
            while len(self._complete_q) >= self._pipeline_depth - 1:
                t_wait = time.monotonic()
                self._complete_cond.wait()
                waited_s += time.monotonic() - t_wait
            self._complete_q.append(record)
            self._complete_cond.notify_all()
        self._util_idle("pipeline_full", waited_s)

    def _complete_loop(self) -> None:
        while True:
            with self._complete_cond:
                while not self._complete_q and not self._worker_done:
                    self._complete_cond.wait()
                if not self._complete_q:
                    return
                record = self._complete_q.popleft()
                self._complete_cond.notify_all()
            self._complete_one(record)

    def _complete_one(self, record: _BatchResult) -> None:
        t_finish = time.monotonic()
        try:
            self._finish(record)
            self._util_busy(time.monotonic() - t_finish, thread="completer")
        except Exception as e:  # noqa: BLE001 - handed to the requests
            # A fault of the fan-out reaches every request it left
            # waiting, as itself, and the thread goes on to the next
            # bucket instead of leaving the pipeline stalled.
            for p in record.live:
                if not p.event.is_set():
                    self._release(p)
                    p.error = e
                    p.event.set()

    def _finish(self, rec: _BatchResult) -> None:
        """Complete one evaluated bucket: error or result fan-out, spans
        and phases, then `end_batch`."""
        if rec.error is not None:
            for p in rec.live:
                self._release(p)
                p.error = rec.error
                p.event.set()
            self._end_batch(rec.generation)
            return
        # The batch's device ms: its span on the stream, complete once the
        # result reached the host (the CPU: the evaluation's wall time);
        # the evaluation's host time outside it is key staging.
        device_ms = rec.eval_ms
        if rec.events is not None:
            rec.events[1].synchronize()
            device_ms = min(rec.eval_ms, rec.events[0].elapsed_time(rec.events[1]))
        self._h_device.observe(device_ms)
        self._util_busy(device_ms / 1e3)
        self._util_idle("staging_sync", (rec.eval_ms - device_ms) / 1e3)
        collected = rec.collected
        # Evaluation time outside any phase bracket is dispatch overhead,
        # clamped at zero (the excess is attribution slop).
        collected_ms = sum(collected.values())
        dispatch_ms = max(0.0, rec.eval_ms - collected_ms)
        slop_ms = max(0.0, collected_ms - rec.eval_ms)
        if slop_ms > 0.0:
            self._c_slop.inc(slop_ms)
        tracing.add_span(
            "batch_assembly", rec.assembly_s * 1e3,
            bucket=rec.bucket, batch_keys=rec.flat_len,
        )
        tracing.add_span(
            "device_compute", rec.eval_ms,
            pad_waste_ratio=round(rec.pad_waste, 4),
        )
        offset = 0
        done = time.monotonic()
        for p in rec.live:
            p.result = rec.results[offset:offset + len(p.keys)]
            offset += len(p.keys)
            queue_wait_ms = (rec.gate_t - p.t0) * 1e3
            self._h_queue_wait.observe(queue_wait_ms)
            self._h_latency.observe((done - p.t0) * 1e3)
            if p.trace is not None:
                p.trace.add_span("queue_wait", queue_wait_ms)
                p.trace.add_span(
                    "batch_assembly", rec.assembly_s * 1e3,
                    bucket=rec.bucket, batch_keys=rec.flat_len,
                )
                p.trace.add_span(
                    "device_compute", rec.eval_ms,
                    pad_waste_ratio=round(rec.pad_waste, 4),
                )
            if p.phases is not None:
                p.phases.add("queue", queue_wait_ms)
                p.phases.add("batch", rec.assembly_s * 1e3)
                p.phases.add_many(collected)
                p.phases.add("dispatch", dispatch_ms)
            self._release(p)
            p.event.set()
        # The batch has retired against its generation: a waiting flip
        # may proceed, and a retired generation's stagings drop once its
        # last batch lands here.
        self._end_batch(rec.generation)
        self._observe_cost(rec, device_ms)

    def _observe_cost(self, rec: _BatchResult, device_ms: float) -> None:
        """Feed the cost ledger one (estimate, truth) pair for this batch:
        the capacity model's price of the executed bucket (corrections
        included, so the recalibration loop closes) and its measured
        device ms, in the cell of the tier that ran."""
        plan = (rec.batch_phases.get_meta("serving_plan")
                if rec.batch_phases is not None else None) or {}
        pricer = self._cost_pricer
        predicted = (pricer(rec.bucket) if pricer is not None
                     else default_capacity_model().price_pir_keys(rec.bucket))
        trace = next((p.trace for p in rec.live if p.trace is not None), None)
        costmodel_mod.default_cost_ledger().observe(
            self._cost_workload, str(plan.get("mode", "unplanned")), str(rec.bucket),
            predicted_device_ms=predicted.device_ms, actual_device_ms=device_ms,
            transfer_bytes=rec.transfer_bytes, trace=trace,
        )

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, then stop the worker and the completion
        thread, so every in-flight bucket fans out before close()
        returns. Later submits raise."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
        if self._completer is not None:
            with self._complete_cond:
                self._worker_done = True
                self._complete_cond.notify_all()
            self._completer.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
