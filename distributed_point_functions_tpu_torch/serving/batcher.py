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
  growing the backlog.
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
* The batches are pipelined two deep: a completion thread fans out
  bucket N-1 (results, spans and phases, `end_batch`) while the worker
  dispatches bucket N. The generation is bound at dispatch by the
  worker, so snapshot flips land only at batch boundaries, and a
  bucket's `end_batch` fires only after its last response fans out,
  which is after its result reached the host: a retired generation's
  staging is never freed under a batch that reads it.

An evaluation's error reaches every request of its batch as that
exception: the batcher never answers in its place.

Not carried from the JAX package (they come with their modules):
cost-aware admission and its weighted-fair queue
(`capacity/admission.py`), brownout batch caps (`capacity/brownout.py`),
the cost-ledger feed (`observability/costmodel.py`), utilization
accounting (`observability/utilization.py`) and mesh key multiples.

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

from ..observability import phases as phases_mod
from ..observability import tracing
from ..observability.device import default_telemetry, shape_key
from ..robustness import failpoints
from .metrics import MetricsRegistry


class Overloaded(RuntimeError):
    """The request was shed at admission, not enqueued. `retry_after_s`
    is the server's backoff hint (0 = none given) and `reason` a short
    cause, when one is known."""

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
        "trace", "phases", "generation",
    )

    def __init__(self, keys, deadline):
        self.keys = keys
        self.deadline = deadline
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
    )

    def __init__(self):
        self.results = None
        self.error = None
        self.collected = {}
        self.eval_ms = 0.0


class DynamicBatcher:
    """See module docstring. One background worker forms and evaluates
    batches and a completion thread fans them out; `submit`
    blocks the calling thread until its slice of the batch result is
    ready, or raises `Overloaded` / `DeadlineExceeded` / the evaluation's
    error. `device`: a CUDA device gives the worker its own stream; None
    or the CPU runs on the thread's current stream."""

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
    ):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._evaluate = evaluate
        self._max_batch_size = max_batch_size
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
        self._cond = threading.Condition()
        self._queue: deque = deque()
        # Snapshot rotation hook (`serving/snapshots.py`): begin_batch()
        # and end_batch() around every evaluation.
        self._generation_source = None
        self._closed = False
        # The pipeline's handoff: at most one evaluated bucket waits for
        # the completion thread.
        self._complete_q: deque = deque()
        self._complete_cond = threading.Condition()
        self._worker_done = False
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

    def submit(self, keys: Sequence, deadline: Optional[float] = None) -> List:
        """Evaluate `keys` as part of a coalesced batch; returns one
        result per key, in order. `deadline` is absolute
        `time.monotonic()` seconds."""
        results, _ = self.submit_ex(keys, deadline)
        return results

    def submit_ex(self, keys: Sequence, deadline: Optional[float] = None):
        """`submit`, returning `(results, generation)`: the snapshot
        generation the batch evaluated against (None without a
        generation source)."""
        keys = list(keys)
        if not keys:
            raise ValueError("keys must not be empty")
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._queue) >= self._max_queue:
                self._c_shed.inc()
                raise Overloaded(
                    f"{self._name}: admission queue full "
                    f"({self._max_queue} requests waiting)",
                    reason="queue_full",
                )
            pending = _Pending(keys, deadline)
            self._queue.append(pending)
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

    # -- worker -------------------------------------------------------------

    def _collect(self):
        """Block for the first request, then fill the batch until
        `max_batch_size` keys or `max_wait_ms` elapse. Returns (batch,
        assembly seconds), or None at shutdown with an empty queue."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait()
            t_first = time.monotonic()
            batch = [self._queue.popleft()]
            num_keys = len(batch[0].keys)
            close_at = t_first + self._max_wait_s
            while num_keys < self._max_batch_size:
                if self._queue:
                    nxt = self._queue[0]
                    if num_keys + len(nxt.keys) > self._max_batch_size:
                        break
                    self._queue.popleft()
                    batch.append(nxt)
                    num_keys += len(nxt.keys)
                    continue
                remaining = close_at - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cond.wait(remaining)
            self._g_depth.set(len(self._queue))
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
                tracker = default_telemetry().compile_tracker
                recorder = phases_mod.default_phase_recorder()
                t_eval = time.perf_counter()
                with self.metrics.timed(f"{self._name}.evaluate_ms"), \
                        tracker.dispatch(
                            f"{self._name}.evaluate",
                            shape_key(("k", bucket)),
                        ), \
                        recorder.collect() as batch_phases:
                    results = list(self._evaluate(padded))
                record.eval_ms = (time.perf_counter() - t_eval) * 1e3
                record.results = results
                record.collected = (
                    batch_phases.snapshot() if batch_phases is not None else {}
                )
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
        """Hand an evaluated bucket to the completion thread through the
        one-slot handoff queue."""
        with self._complete_cond:
            while self._complete_q:
                self._complete_cond.wait()
            self._complete_q.append(record)
            self._complete_cond.notify_all()

    def _complete_loop(self) -> None:
        while True:
            with self._complete_cond:
                while not self._complete_q and not self._worker_done:
                    self._complete_cond.wait()
                if not self._complete_q:
                    return
                record = self._complete_q.popleft()
                self._complete_cond.notify_all()
            try:
                self._finish(record)
            except Exception as e:  # noqa: BLE001 - handed to the requests
                # A fault of the fan-out reaches every request it left
                # waiting, as itself, and the thread goes on to the next
                # bucket instead of leaving the pipeline stalled.
                for p in record.live:
                    if not p.event.is_set():
                        p.error = e
                        p.event.set()

    def _finish(self, rec: _BatchResult) -> None:
        """Complete one evaluated bucket: error or result fan-out, spans
        and phases, then `end_batch`."""
        if rec.error is not None:
            for p in rec.live:
                p.error = rec.error
                p.event.set()
            self._end_batch(rec.generation)
            return
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
            p.event.set()
        # The batch has retired against its generation: a waiting flip
        # may proceed, and a retired generation's stagings drop once its
        # last batch lands here.
        self._end_batch(rec.generation)

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, then stop the worker and the completion
        thread, so every in-flight bucket fans out before close()
        returns. Later submits raise."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
        with self._complete_cond:
            self._worker_done = True
            self._complete_cond.notify_all()
        self._completer.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
