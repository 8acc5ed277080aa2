"""Observability for the serving stack (DESIGN.md §17): one
``MetricsRegistry`` + one bounded ``SpanRecorder`` per engine, bundled
as an ``Observability`` object, with a threadlocal ambient context so
library layers (``core.engine``) record spans without threading an
``obs`` argument through the ``CandidateSource`` protocol.

Spans default **off** — every engine gets a registry (the ``stats``
views need one) but span recording costs nothing unless requested:

    eng = GraphQueryEngine(flat, obs=Observability(spans=True))
    ...
    eng.obs.export_trace("query.trace.json")
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Histogram,
                                     MetricsRegistry, StatsView)
from repro_torch.obs.spans import Span, SpanRecorder

__all__ = ["DEFAULT_BUCKETS", "Histogram", "MetricsRegistry", "StatsView",
           "Span", "SpanRecorder", "Observability", "current_obs",
           "use_obs", "device_annotation"]


class Observability:
    """One engine's metrics registry + span ring (DESIGN.md §17)."""

    def __init__(self, *, spans: bool = False, span_capacity: int = 65536,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.spans = SpanRecorder(capacity=span_capacity, enabled=spans)

    def span(self, name: str, *, qid=None, **args):
        return self.spans.span(name, qid=qid, **args)

    def export_trace(self, path: str) -> str:
        from repro_torch.obs.export import write_trace
        return write_trace(path, self)


_tl = threading.local()


def current_obs() -> Optional[Observability]:
    """The ambient ``Observability`` set by ``use_obs`` on this thread
    (None outside any engine's filter pass)."""
    return getattr(_tl, "obs", None)


@contextlib.contextmanager
def use_obs(obs: Optional[Observability]):
    """Make ``obs`` the ambient context for the with-block.  The serving
    engine wraps its filter stage in this so ``core.engine`` records
    bucket / filter / assign_lb spans without an API change; restores
    the previous context on exit (re-entrant)."""
    prev = getattr(_tl, "obs", None)
    _tl.obs = obs
    try:
        yield obs
    finally:
        _tl.obs = prev


def device_annotation(name: str):
    """``torch.profiler.record_function`` bracket when the ambient obs has
    spans enabled, so a device profile collected alongside lines the
    per-bucket kernel launches up with host spans; otherwise a null
    context."""
    obs = current_obs()
    if obs is None or not obs.spans.enabled:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)
