"""Measured throughput from a bench history file: the calibration the
heavy-hitters pricing of `model.py` reads (the JAX package's
`capacity/model.py:ThroughputCalibration`, with the history path as an
argument and no environment variable). A missing file or a malformed
line degrades to the caller's fallback, journaled once per metric."""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Optional


class ThroughputCalibration:
    """Measured throughput per metric from a bench history file (JSON
    lines of `{"metric", "value", "status"}`): the newest clean record
    (`status == "ok"`, a finite positive value) per metric, read once,
    lazily. Without a file, or without a clean record of a metric,
    `throughput` returns the caller's fallback and journals that once per
    metric (`capacity.calibration_fallback`)."""

    def __init__(self, history_path: Optional[str] = None):
        self._path = history_path
        self._lock = threading.Lock()
        self._loaded = False
        self._newest: Dict[str, float] = {}
        self._fallback_noted: set = set()

    def _load(self) -> None:
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            if self._path is None:
                return
            try:
                with open(self._path) as f:
                    lines = f.readlines()
            except OSError:
                return
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                value = rec.get("value")
                if (str(rec.get("status", "ok")) == "ok"
                        and isinstance(value, (int, float))
                        and math.isfinite(float(value)) and float(value) > 0):
                    # File order is append order: the last clean record wins.
                    self._newest[str(rec.get("metric"))] = float(value)

    def lookup(self, metric: str) -> Optional[float]:
        """The newest clean measurement of `metric`, or None."""
        self._load()
        return self._newest.get(metric)

    def throughput(self, metric: str, fallback: float) -> float:
        value = self.lookup(metric)
        if value is not None:
            return value
        with self._lock:
            first = metric not in self._fallback_noted
            self._fallback_noted.add(metric)
        if first:
            from ..observability import events as events_mod

            events_mod.emit(
                "capacity.calibration_fallback",
                message=(f"no clean history record for {metric}; pricing "
                         f"with the fallback {fallback:g}"),
                severity="warning", metric=metric, fallback=fallback,
                history_path=self._path)
        return fallback

    def export(self) -> dict:
        """The history path and the newest clean value of each metric."""
        self._load()
        with self._lock:
            newest = dict(sorted(self._newest.items()))
        return {"history_path": self._path, "calibrated_metrics": newest}
