"""Per-stage health state machine.

In this package the verifier process pool owns one (the device filter
stage has no fallback: a kernel failure raises).  A
:class:`StageHealth` tracks

    HEALTHY --fail x fail_threshold--> FAILING --probe ok--> HEALTHY
       \\--fail--> DEGRADED --ok--> HEALTHY

* ``HEALTHY``  — use the primary path.
* ``DEGRADED`` — recent failure(s); primary still attempted.
* ``FAILING``  — ``fail_threshold`` consecutive failures; the primary
  is *sticky-skipped* and only re-attempted as a probe every
  ``probe_interval`` calls (sticky-until-probe recovery, DESIGN.md
  §18).  One successful probe restores HEALTHY.

State changes are mirrored into a ``MetricsRegistry`` when one is
attached (``health.<stage>`` gauge: 0 healthy / 1 degraded / 2
failing, plus failure/probe counters), so ladder decisions are visible
in the same snapshot as the serving stats.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

HEALTHY, DEGRADED, FAILING = "healthy", "degraded", "failing"
_CODE = {HEALTHY: 0, DEGRADED: 1, FAILING: 2}


class StageHealth:
    """Thread-safe tri-state health tracker with probe-based recovery."""

    def __init__(self, stage: str, *, fail_threshold: int = 3,
                 probe_interval: int = 8,
                 registry: Optional[MetricsRegistry] = None) -> None:
        if fail_threshold < 1 or probe_interval < 1:
            raise ValueError("fail_threshold and probe_interval are >= 1")
        self.stage = stage
        self.fail_threshold = fail_threshold
        self.probe_interval = probe_interval
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._consec_failures = 0
        self._calls_since_trip = 0
        self._registry: Optional[MetricsRegistry] = None
        self.attach(registry)

    # ------------------------------------------------------------------
    def attach(self, registry: Optional[MetricsRegistry]) -> None:
        """(Re)bind the metrics registry and publish current state."""
        with self._lock:
            self._registry = registry
            self._publish_locked()

    def _publish_locked(self) -> None:
        if self._registry is not None:
            self._registry.gauge_set(f"health.{self.stage}",
                                     _CODE[self._state])

    def _count(self, name: str) -> None:
        if self._registry is not None:
            self._registry.counter_add(f"health.{self.stage}.{name}")

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow_primary(self) -> bool:
        """Should this call attempt the primary path?

        True while HEALTHY/DEGRADED.  While FAILING, True only on every
        ``probe_interval``-th call (the probe); otherwise the caller
        goes straight to its fallback without paying the failure."""
        with self._lock:
            if self._state != FAILING:
                return True
            self._calls_since_trip += 1
            if self._calls_since_trip >= self.probe_interval:
                self._calls_since_trip = 0
                self._count("probes")
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consec_failures = 0
            if self._state != HEALTHY:
                self._state = HEALTHY
                self._count("recoveries")
                self._publish_locked()

    def record_failure(self) -> None:
        with self._lock:
            self._consec_failures += 1
            self._count("failures")
            prev = self._state
            if self._consec_failures >= self.fail_threshold:
                self._state = FAILING
                self._calls_since_trip = 0
            else:
                self._state = DEGRADED
            if self._state != prev:
                self._publish_locked()

    def snapshot(self) -> dict:
        with self._lock:
            return {"stage": self.stage, "state": self._state,
                    "consec_failures": self._consec_failures}
