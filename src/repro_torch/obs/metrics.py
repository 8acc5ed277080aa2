"""Lock-safe metrics registry for the serving stack (DESIGN.md §17).

One ``MetricsRegistry`` per engine (and one per ``VerifyScheduler``):
monotonic counters, gauges, and fixed-bucket histograms behind a single
lock, cheap enough for the verifier hot loop — one uncontended
lock/bisect per observation, no allocation on the update path.

Three aggregation APIs make worker stats foldable into one view
regardless of where they were counted:

* ``snapshot()`` — a consistent plain-dict copy (safe to serialise,
  pickle across the process pool, or diff later);
* ``delta(new, old)`` — what happened *between* two snapshots
  (counters/histograms subtract, gauges keep the newer value);
* ``merge(a, b)`` — fold two snapshots into one (counters/histograms
  add, gauges take the max).  ``merge`` is associative and commutative
  on counters/histograms, so sync, async, process-pool, and
  sharded-subprocess paths can fold in any order.

``StatsView`` is the compatibility shim: a ``MutableMapping`` over one
registry namespace, so the pre-existing ``stats["verified_pairs"] += 1``
idiom (and every test that reads those keys) keeps working while the
numbers actually live in the registry.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterator, List, MutableMapping, Optional, Sequence

__all__ = ["DEFAULT_BUCKETS", "Histogram", "MetricsRegistry", "StatsView"]

# latency buckets in seconds (upper bounds; one implicit +inf overflow)
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Fixed-bucket histogram: counts per upper bound plus an overflow
    slot, total sum and count.  Mutated only by the owning registry,
    under its lock."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Counters / gauges / histograms behind one lock (DESIGN.md §17).

    Metric names are flat strings; ``view(namespace)`` scopes a
    ``StatsView`` to ``"<namespace>.<key>"`` names so independent
    components sharing a registry cannot collide.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}    # guarded_by: self._lock
        self._gauges: Dict[str, float] = {}      # guarded_by: self._lock
        self._hists: Dict[str, Histogram] = {}   # guarded_by: self._lock

    # ---- counters ----------------------------------------------------------
    def counter_add(self, name: str, value=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counter_set(self, name: str, value) -> None:
        """Absolute set — exists for the ``StatsView`` mapping shim; the
        callers that use it (``stats[k] += 1`` under their own outer
        lock) preserve monotonicity themselves."""
        with self._lock:
            self._counters[name] = value

    def counter_get(self, name: str, default=None):
        with self._lock:
            if name not in self._counters:
                if default is None:
                    raise KeyError(name)
                return default
            return self._counters[name]

    def counter_del(self, name: str) -> None:
        with self._lock:
            del self._counters[name]

    # ---- gauges ------------------------------------------------------------
    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    # ---- histograms --------------------------------------------------------
    def observe(self, name: str, value: float,
                bounds: Sequence[float] = DEFAULT_BUCKETS) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(bounds)
            h.observe(value)

    # ---- namespace helpers (the StatsView backend) -------------------------
    def ns_keys(self, prefix: str) -> List[str]:
        with self._lock:
            return [k[len(prefix):] for k in self._counters
                    if k.startswith(prefix)]

    def ns_snapshot(self, prefix: str) -> Dict[str, float]:
        """Consistent copy of one namespace's counters, prefix stripped —
        all keys read under a single lock acquisition."""
        with self._lock:
            return {k[len(prefix):]: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    # ---- aggregation -------------------------------------------------------
    def snapshot(self) -> dict:
        """A consistent plain-dict copy of everything: pickles across the
        process pool, serialises into trace artifacts, diffs/merges with
        the static helpers below."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "hists": {k: h.to_dict()
                              for k, h in self._hists.items()}}

    def absorb(self, snap: dict) -> None:
        """Fold a worker snapshot (or a ``delta``) into this registry:
        counters/histogram counts add, gauges take the max."""
        hists = snap.get("hists", {})
        with self._lock:
            for k, v in snap.get("counters", {}).items():
                self._counters[k] = self._counters.get(k, 0) + v
            for k, v in snap.get("gauges", {}).items():
                self._gauges[k] = max(self._gauges.get(k, v), v)
            for k, hd in hists.items():
                h = self._hists.get(k)
                if h is None:
                    h = self._hists[k] = Histogram(hd["bounds"])
                if tuple(hd["bounds"]) != h.bounds:
                    raise ValueError(
                        f"histogram {k!r}: bucket bounds differ")
                for i, c in enumerate(hd["counts"]):
                    h.counts[i] += c
                h.sum += hd["sum"]
                h.count += hd["count"]

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        """Fold two snapshots: counters/histograms add, gauges max.
        Associative and commutative, so any fold order over worker
        snapshots produces the same totals."""
        out = {"counters": dict(a.get("counters", {})),
               "gauges": dict(a.get("gauges", {})),
               "hists": {k: {**h, "bounds": list(h["bounds"]),
                             "counts": list(h["counts"])}
                         for k, h in a.get("hists", {}).items()}}
        for k, v in b.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in b.get("gauges", {}).items():
            out["gauges"][k] = max(out["gauges"].get(k, v), v)
        for k, hd in b.get("hists", {}).items():
            h = out["hists"].get(k)
            if h is None:
                out["hists"][k] = {**hd, "bounds": list(hd["bounds"]),
                                   "counts": list(hd["counts"])}
                continue
            if list(hd["bounds"]) != list(h["bounds"]):
                raise ValueError(f"histogram {k!r}: bucket bounds differ")
            h["counts"] = [x + y for x, y in zip(h["counts"],
                                                 hd["counts"])]
            h["sum"] += hd["sum"]
            h["count"] += hd["count"]
        return out

    @staticmethod
    def delta(new: dict, old: dict) -> dict:
        """What happened between two snapshots of the *same* registry:
        counters/histograms subtract (missing old keys count from 0),
        gauges keep the newer value."""
        out = {"counters": {}, "gauges": dict(new.get("gauges", {})),
               "hists": {}}
        oldc = old.get("counters", {})
        for k, v in new.get("counters", {}).items():
            out["counters"][k] = v - oldc.get(k, 0)
        oldh = old.get("hists", {})
        for k, hd in new.get("hists", {}).items():
            oh = oldh.get(k)
            if oh is None:
                out["hists"][k] = {**hd, "bounds": list(hd["bounds"]),
                                   "counts": list(hd["counts"])}
                continue
            out["hists"][k] = {
                "bounds": list(hd["bounds"]),
                "counts": [x - y for x, y in zip(hd["counts"],
                                                 oh["counts"])],
                "sum": hd["sum"] - oh["sum"],
                "count": hd["count"] - oh["count"]}
        return out

    def view(self, namespace: str,
             initial: Optional[Dict[str, float]] = None) -> "StatsView":
        return StatsView(self, namespace, initial)


class StatsView(MutableMapping):
    """A dict-shaped window onto one registry namespace (DESIGN.md §17).

    Drop-in for the ad-hoc ``stats`` dicts the serving stack grew up
    with: ``view["verified_pairs"] += 1``, ``dict(view)``,
    ``view.get(k, 0)`` all behave as before, but every key lives in the
    registry as ``"<namespace>.<key>"`` so one snapshot/merge pass sees
    the whole system.  ``+=`` is read-then-write (two lock trips), which
    matches the old dict's discipline: every pre-existing mutation site
    already serialises under its component's outer lock.
    """

    __slots__ = ("_reg", "_prefix")

    def __init__(self, registry: MetricsRegistry, namespace: str,
                 initial: Optional[Dict[str, float]] = None):
        self._reg = registry
        self._prefix = namespace + "."
        if initial:
            for k, v in initial.items():
                registry.counter_set(self._prefix + k, v)

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    def __getitem__(self, key: str):
        return self._reg.counter_get(self._prefix + key)

    def __setitem__(self, key: str, value) -> None:
        self._reg.counter_set(self._prefix + key, value)

    def __delitem__(self, key: str) -> None:
        self._reg.counter_del(self._prefix + key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._reg.ns_keys(self._prefix))

    def __len__(self) -> int:
        return len(self._reg.ns_keys(self._prefix))

    def __repr__(self) -> str:
        return f"StatsView({self.snapshot()!r})"

    def snapshot(self) -> Dict[str, float]:
        """Consistent copy under one lock acquisition — what
        ``stats_snapshot()`` callers should hand out."""
        return self._reg.ns_snapshot(self._prefix)
