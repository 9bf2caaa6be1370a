"""Device-level telemetry: first dispatches, device memory, transfers.

The port's counterpart of the JAX package's `observability/device.py`,
on `torch.cuda`. The metric names are the JAX package's, so dashboards
read either; what they count in the port:

* `CompileTracker` -- "compile" is the **first dispatch of a shape** at
  a site (the batcher's power-of-two key buckets, `("k", bucket)`). The
  port has no jit: its kernels are built once per process from `csrc/`
  by `ops.cuda_lib` (the build's seconds are `chip_smoke.py`'s `build`
  line), so a first dispatch pays only the planner's caches and the
  caching allocator's first blocks for that shape. `device.compiles`
  and `device.dispatch_hits` keep their names; `device.compile_ms` is
  that first dispatch's wall time.
* `HbmAccountant` -- live device bytes from
  `torch.cuda.memory_allocated`, and the allocator's own peak from
  `torch.cuda.max_memory_allocated` (`export()["peak_bytes"]`), with
  per-phase watermarks (`phase("db_staging")`). On the CPU both read 0
  with source `"cpu"`.
* `TransferLedger` -- the port's real host<->device copies (the
  database's staging and delta rows, the staged keys, the response rows
  read back) and the syncs that end a batch, each recorded where it
  happens (`pir/database.py`, `pir/server.py`) with its bytes and the
  phase it belongs to.

The JAX package's `jax.monitoring` bridge has no counterpart: there is
no compiler to listen to. The classes mirror into a duck-typed metrics
registry (`serving/metrics.py`) once a process binds one
(`default_telemetry().bind_registry(...)`; no session binds it, since
the telemetry is the process's, not a party's), and keep their own
state, so exports stay consistent across registry resets.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..robustness import failpoints

__all__ = [
    "CompileTracker",
    "HbmAccountant",
    "TransferLedger",
    "DeviceTelemetry",
    "default_telemetry",
    "set_default_telemetry",
    "shape_key",
]


def shape_key(*parts) -> str:
    """Canonical shape-key string for a jit specialization signature.

    Accepts ints, strings, arrays (anything with `.shape`/`.dtype`),
    and nested tuples; renders to a short label-safe token (no
    `,={}` — the registry's reserved label characters), e.g.
    `shape_key(("q", 64), ("b", 8192))` -> `"q64.b8192"`.
    """
    toks = []
    for part in parts:
        if isinstance(part, tuple) and len(part) == 2 and isinstance(
            part[0], str
        ):
            prefix, value = part
        else:
            prefix, value = "", part
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            dims = "x".join(str(d) for d in value.shape)
            toks.append(f"{prefix}{dims or 'scalar'}.{value.dtype}")
        else:
            toks.append(f"{prefix}{value}")
    key = ".".join(toks) or "default"
    for c in ",={}":
        key = key.replace(c, "_")
    return key


class CompileTracker:
    """Per-site compile/dispatch accounting keyed by shape signature.

    A *site* is one logical dispatch point ("plain.batcher.evaluate");
    a *shape key* is the signature of its batch (the key bucket).
    `record_dispatch(site, key)` returns True exactly once per (site,
    key) -- the first dispatch, counted as a "compile" -- and False on
    every re-dispatch (a hit).
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._registry = registry
        # (site, shape) -> [compiles, hits]
        self._shapes: Dict[Tuple[str, str], list] = {}
        # site -> list of compile latencies (ms), bounded
        self._compile_ms: Dict[str, list] = {}
        self._max_latencies = 256

    def bind_registry(self, registry) -> None:
        """Mirror future events into `registry` (duck-typed:
        `counter`/`gauge`/`histogram(name, labels=...)`)."""
        with self._lock:
            self._registry = registry

    # -- recording ----------------------------------------------------------

    def record_dispatch(
        self,
        site: str,
        key: str,
        compile_ms: Optional[float] = None,
    ) -> bool:
        """Count one dispatch of `site` at shape `key`. Returns True if
        this is the first sighting (a compile), else False (a hit).
        `compile_ms` attributes a measured first-call latency; pass it
        only when the call was actually timed."""
        with self._lock:
            entry = self._shapes.get((site, key))
            fresh = entry is None
            if fresh:
                self._shapes[(site, key)] = [1, 0]
            else:
                entry[1] += 1
            registry = self._registry
        if registry is not None:
            try:
                if fresh:
                    registry.counter(
                        "device.compiles", labels={"site": site}
                    ).inc()
                    registry.gauge(
                        "device.distinct_shapes", labels={"site": site}
                    ).inc()
                else:
                    registry.counter(
                        "device.dispatch_hits", labels={"site": site}
                    ).inc()
            except Exception:  # pragma: no cover - telemetry never raises
                pass
        if fresh and compile_ms is not None:
            self.record_compile_ms(site, compile_ms)
        return fresh

    def record_compile_ms(self, site: str, compile_ms: float) -> None:
        with self._lock:
            lat = self._compile_ms.setdefault(site, [])
            lat.append(float(compile_ms))
            del lat[: -self._max_latencies]
            registry = self._registry
        if registry is not None:
            try:
                registry.histogram(
                    "device.compile_ms", labels={"site": site}
                ).observe(float(compile_ms))
            except Exception:  # pragma: no cover
                pass

    @contextlib.contextmanager
    def dispatch(self, site: str, key: str):
        """Bracket one dispatch: times the call, and attributes the
        wall time as first-dispatch latency iff the shape is new.

        Chaos site `device.dispatch.<site>`: armed with action="oom"
        it raises `SimulatedResourceExhausted` at dispatch, standing
        in for the allocator failing this batch.
        """
        failpoints.fire(f"device.dispatch.{site}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            # Record after the call so the compile histogram sees the
            # real first-call latency, not a guess made on entry.
            with self._lock:
                seen = (site, key) in self._shapes
            self.record_dispatch(
                site, key, compile_ms=None if seen else elapsed_ms
            )

    # -- reading ------------------------------------------------------------

    def seen(self, site: str, key: str) -> bool:
        """Whether (site, key) has dispatched before, i.e. whether the
        NEXT dispatch at this shape is a hit (`dispatch()` registers the
        shape on exit)."""
        with self._lock:
            return (site, key) in self._shapes

    def compiles(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                v[0] for (s, _), v in self._shapes.items()
                if site is None or s == site
            )

    def hits(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                v[1] for (s, _), v in self._shapes.items()
                if site is None or s == site
            )

    def export(self) -> dict:
        """Per-site summary for /statusz: shapes, compiles, hits,
        hit ratio, compile-latency percentiles."""
        with self._lock:
            shapes = {k: list(v) for k, v in self._shapes.items()}
            latencies = {s: list(v) for s, v in self._compile_ms.items()}
        sites: Dict[str, dict] = {}
        for (site, key), (compiles, hits) in sorted(shapes.items()):
            site_entry = sites.setdefault(
                site,
                {"shapes": {}, "compiles": 0, "hits": 0},
            )
            site_entry["shapes"][key] = {"compiles": compiles, "hits": hits}
            site_entry["compiles"] += compiles
            site_entry["hits"] += hits
        for site, entry in sites.items():
            total = entry["compiles"] + entry["hits"]
            entry["hit_ratio"] = (
                round(entry["hits"] / total, 4) if total else None
            )
            lat = sorted(latencies.get(site, ()))
            if lat:
                entry["compile_ms"] = {
                    "count": len(lat),
                    "p50": round(lat[len(lat) // 2], 3),
                    "max": round(lat[-1], 3),
                }
        return {"sites": sites, "total_compiles": self.compiles()}

    def reset(self) -> None:
        with self._lock:
            self._shapes.clear()
            self._compile_ms.clear()


# ---------------------------------------------------------------------------
# Device memory accounting
# ---------------------------------------------------------------------------


def _live_bytes() -> Tuple[int, str]:
    """(live bytes, source) of the current CUDA device:
    `torch.cuda.memory_allocated` (tensors alive, not the allocator's
    cache); (0, "cpu") without a card."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0, "cpu"
    return int(torch.cuda.memory_allocated()), "memory_allocated"


class HbmAccountant:
    """Live-bytes watermarks with per-phase attribution.

    Phases name what the process is doing when memory peaks --
    `db_staging` (the database's staging, full or delta), `selection`
    (a batch's selection tensors). Within one phase occurrence the
    watermark is monotone non-decreasing; re-entering the phase resets
    it, so the gauge always describes the most recent occurrence. The
    name is the JAX package's; on the card it is the device's memory.
    """

    def __init__(self, registry=None, sampler: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._registry = registry
        self._sampler = sampler or _live_bytes
        self._watermarks: Dict[str, int] = {}
        self._current_phase: Optional[str] = None
        self._last_bytes = 0
        self._last_source = "unsampled"
        self._samples = 0

    def bind_registry(self, registry) -> None:
        with self._lock:
            self._registry = registry

    @contextlib.contextmanager
    def phase(self, name: str):
        """Bracket a phase occurrence: resets `name`'s watermark, takes
        an entry and an exit sample, and attributes any `sample()` call
        inside the bracket to `name`. Phases do not nest -- the
        innermost bracket wins, and the outer phase resumes on exit."""
        with self._lock:
            prev = self._current_phase
            self._current_phase = name
            self._watermarks[name] = 0
        self.sample()
        try:
            yield
        finally:
            self.sample()
            with self._lock:
                self._current_phase = prev

    def sample(self) -> int:
        """Take one live-bytes sample, raising the current phase's
        watermark (and the unattributed `process` watermark)."""
        value, source = self._sampler()
        value = int(value)
        with self._lock:
            self._samples += 1
            self._last_bytes = value
            self._last_source = source
            phase = self._current_phase or "process"
            self._watermarks[phase] = max(
                value, self._watermarks.get(phase, 0)
            )
            registry = self._registry
            watermark = self._watermarks[phase]
        if registry is not None:
            registry.gauge("device.hbm_live_bytes").set(value)
            registry.gauge(
                "device.hbm_watermark_bytes", labels={"phase": phase}
            ).set(watermark)
            registry.counter("device.hbm_samples").inc()
        return value

    def watermark(self, phase: str) -> int:
        with self._lock:
            return self._watermarks.get(phase, 0)

    def export(self) -> dict:
        peak = (
            int(torch.cuda.max_memory_allocated())
            if torch.cuda.is_available() and torch.cuda.is_initialized()
            else 0
        )
        with self._lock:
            return {
                "live_bytes": self._last_bytes,
                "peak_bytes": peak,
                "source": self._last_source,
                "samples": self._samples,
                "current_phase": self._current_phase,
                "watermark_bytes": dict(sorted(self._watermarks.items())),
            }

    def reset(self) -> None:
        with self._lock:
            self._watermarks.clear()
            self._current_phase = None
            self._last_bytes = 0
            self._last_source = "unsampled"
            self._samples = 0


# ---------------------------------------------------------------------------
# Host<->device transfer accounting
# ---------------------------------------------------------------------------


class TransferLedger:
    """Per-phase host<->device transfer counts and bytes.

    Call sites record their copies where they make them
    (`record_h2d` / `record_d2h` / `record_sync`), or sync through
    `synchronize(device, phase=...)`, one counted sync of the current
    stream. Only copies that cross the bus are counted. Phases name the
    site (`db_staging`, `db_readback`, `result_readback`). With
    `enabled=False` nothing is recorded.

    Syncs are counted apart from copies: a pipelined staging issues many
    asynchronous copies and drains them with ONE final sync, so
    `syncs < copies` is the signature of transfers that overlapped host
    work. `record_overlap(ms, phase)` adds the companion `overlapped_ms`:
    host milliseconds of useful work done while copies were in flight
    (the hidden half of the phase's transfer time; the exposed half is
    what the final sync still waits, `sync_wait_ms`).
    """

    def __init__(self, registry=None, enabled: bool = True):
        self._lock = threading.Lock()
        self._registry = registry
        self.enabled = enabled
        # phase -> {h2d_copies, h2d_bytes, d2h_copies, d2h_bytes,
        #           syncs, sync_wait_ms, overlapped_ms}
        self._phases: Dict[str, Dict[str, float]] = {}

    def bind_registry(self, registry) -> None:
        with self._lock:
            self._registry = registry

    # -- recording ----------------------------------------------------------

    @staticmethod
    def _new_entry() -> Dict[str, float]:
        return {"h2d_copies": 0, "h2d_bytes": 0, "d2h_copies": 0,
                "d2h_bytes": 0, "syncs": 0, "sync_wait_ms": 0.0,
                "overlapped_ms": 0.0}

    def _add(self, phase: str, **deltas) -> None:
        if not self.enabled:
            return
        with self._lock:
            entry = self._phases.setdefault(phase, self._new_entry())
            for k, v in deltas.items():
                entry[k] += v
            registry = self._registry
        if registry is not None:
            labels = {"phase": phase}
            for k, v in deltas.items():
                name = {"syncs": "device.sync_waits"}.get(k, f"device.{k}")
                registry.counter(name, labels=labels).inc(v)

    def record_h2d(self, nbytes: int, phase: str, copies: int = 1) -> None:
        self._add(phase, h2d_copies=copies, h2d_bytes=int(nbytes))

    def record_d2h(self, nbytes: int, phase: str, copies: int = 1) -> None:
        self._add(phase, d2h_copies=copies, d2h_bytes=int(nbytes))

    def record_sync(self, phase: str, wait_ms: float = 0.0) -> None:
        """One host<->device sync; `wait_ms` is the host wall time it
        blocked (the exposed half of the phase's transfer time)."""
        self._add(phase, syncs=1, sync_wait_ms=max(0.0, float(wait_ms)))

    def record_overlap(self, ms: float, phase: str) -> None:
        """Credit `ms` of host work done while transfers of `phase` were
        in flight (the hidden half of the phase's transfer time)."""
        ms = float(ms)
        if ms > 0.0:
            self._add(phase, overlapped_ms=ms)

    # -- counted sync -------------------------------------------------------

    def synchronize(self, device, *, phase: str = "unattributed") -> None:
        """Wait for the current stream of `device` (a CUDA device; a
        no-op on the CPU), counted as one sync."""
        device = torch.device(device)
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        torch.cuda.current_stream(device).synchronize()
        self.record_sync(phase, wait_ms=(time.perf_counter() - t0) * 1e3)

    # -- reading ------------------------------------------------------------

    def _sum(self, field: str, phase: Optional[str]):
        with self._lock:
            return sum(
                e[field] for p, e in self._phases.items()
                if phase is None or p == phase
            )

    def copies(self, phase: Optional[str] = None) -> int:
        """h2d copy count (one phase, or all phases)."""
        return self._sum("h2d_copies", phase)

    def bytes_h2d(self, phase: Optional[str] = None) -> int:
        return self._sum("h2d_bytes", phase)

    def syncs(self, phase: Optional[str] = None) -> int:
        return self._sum("syncs", phase)

    def sync_wait_ms(self, phase: Optional[str] = None) -> float:
        return self._sum("sync_wait_ms", phase)

    def overlapped_ms(self, phase: Optional[str] = None) -> float:
        """Milliseconds of transfer time hidden behind host work."""
        return self._sum("overlapped_ms", phase)

    def export(self) -> dict:
        with self._lock:
            phases = {p: dict(e) for p, e in sorted(self._phases.items())}
        totals = self._new_entry()
        for entry in phases.values():
            for k in totals:
                totals[k] += entry[k]
        for ms_key in ("overlapped_ms", "sync_wait_ms"):
            totals[ms_key] = round(totals[ms_key], 3)
            for entry in phases.values():
                entry[ms_key] = round(entry[ms_key], 3)
        return {"enabled": self.enabled, "totals": totals,
                "phases": phases}

    def reset(self) -> None:
        with self._lock:
            self._phases.clear()


# ---------------------------------------------------------------------------
# Process-default telemetry
# ---------------------------------------------------------------------------


class DeviceTelemetry:
    """One process's device telemetry: a first-dispatch tracker, a
    device-memory accountant, and a transfer ledger, bound to at most
    one metrics registry."""

    def __init__(self, registry=None):
        self.compile_tracker = CompileTracker(registry)
        self.hbm = HbmAccountant(registry)
        self.transfers = TransferLedger(registry)

    def bind_registry(self, registry) -> None:
        self.compile_tracker.bind_registry(registry)
        self.hbm.bind_registry(registry)
        self.transfers.bind_registry(registry)

    def export(self) -> dict:
        return {
            "compile": self.compile_tracker.export(),
            "hbm": self.hbm.export(),
            "transfers": self.transfers.export(),
        }

    def reset(self) -> None:
        self.compile_tracker.reset()
        self.hbm.reset()
        self.transfers.reset()


_DEFAULT = DeviceTelemetry()


def default_telemetry() -> DeviceTelemetry:
    """The process-wide telemetry instance the hot paths report into
    (looked up per call, so `set_default_telemetry` reaches every site
    at once)."""
    return _DEFAULT


def set_default_telemetry(telemetry: DeviceTelemetry) -> DeviceTelemetry:
    global _DEFAULT
    _DEFAULT = telemetry
    return telemetry
