"""Batched multi-query candidate generation — the GraphQueryEngine core.

Serving a batch of queries one at a time would repeat the region
bookkeeping per query and re-touch every region graph once per query.
This module amortises both:

Stage 1 — **bucket** (``bucket_queries``): group requests by their reduced
  query region rectangle (formula (1)).  Every query in a bucket prunes
  against the *identical* set of region graphs, so that set is gathered
  once per batch.

Stage 2 — **gather**: the bucket's ``FilterSlab`` rows are gathered once,
  padded to the filter kernel's shape bucket, uploaded to the backend's
  device and kept there in the ``DeviceSlabCache`` (DESIGN.md §13).  The
  slab's F_D carrier is ``dense``, ``hot`` (hot prefix on the device,
  the CSR tail's C_D correction computed on the host and fed to the
  kernel as its C_D seed ``cdt``) or ``packed`` (the bucket's bit-packed
  rows stay on the device in that form and are decoded there on every
  launch, the bit-unpack kernel on ``cuda``; DESIGN.md §11).

Stage 3 — **filter** (``BatchedFilterEval``): the full leaf-level filter
  cascade for the whole bucket in one (Q, N) pass.  Backends: ``cuda``
  (the hand-written q-gram filter kernel, one launch per bucket),
  ``torch`` (its plain PyTorch version, on any device) and ``numpy``
  (the host oracle, per-query vectorised rows).

Stage 1.5 — **assignment LB** (DESIGN.md §16): over each bucket's union
  of survivors, one batched Hausdorff branch-LB pass (the assign_lb
  kernel on ``cuda``, its plain version on ``torch``, ``assign_lb_np`` on
  ``numpy``).

There is no fallback between backends: a kernel that cannot build or
launch raises out of the pass.  Stage 4 (the shared verification
worklist) lives in ``repro_torch.serve.graph_engine``; the
``CandidateSource`` protocol below is what it needs from an index.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core import arrays, filters
from repro_torch.core.arrays import QueryArrays
from repro_torch.core.device_cache import DeviceSlabCache, bucket_key
from repro_torch.core.qgrams import EncodedDB, QGramVocab
from repro_torch.core.region import RegionPartition
from repro_torch.core.slab import FilterSlab, branch_features
from repro_torch.core.tree import QueryTuple
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import Graph, GraphDB
from repro_torch.kernels.assign_lb import kernel as lb_kernel
from repro_torch.kernels.assign_lb import ops as lb_ops
from repro_torch.kernels.assign_lb import ref as lb_ref
from repro_torch.kernels.bitunpack import kernel as bu_kernel
from repro_torch.kernels.bitunpack import ops as bu_ops
from repro_torch.kernels.bitunpack import ref as bu_ref
from repro_torch.kernels.qgram_filter import kernel as qf_kernel
from repro_torch.kernels.qgram_filter import ops as qf_ops
from repro_torch.kernels.qgram_filter import ref as qf_ref
from repro_torch.obs import current_obs, device_annotation

Rect = Tuple[int, int, int, int]          # inclusive (i1, i2, j1, j2)


@runtime_checkable
class CandidateSource(Protocol):
    """What the serving engine needs from an index."""

    db: GraphDB
    vocab: QGramVocab
    partition: RegionPartition

    def candidate_ids(self, h: Graph, tau: int) -> List[int]:
        """Sorted candidate graph ids for one query."""
        ...

    def batched_candidates(self, graphs: Sequence[Graph],
                           taus: Sequence[int],
                           qtuples: Optional[Sequence[QueryTuple]] = None,
                           **kw) -> "CandidateBatch":
        """Candidates for a whole batch; per-query order preserved."""
        ...


@dataclass
class CandidateBatch:
    """Per-query candidate ids plus the filter lower bounds, used to order
    the shared verification worklist.

    ``lbs`` carries the stage-1.5 assignment lower bounds (DESIGN.md
    §16), aligned with ``ids`` like ``bounds``.  The LB never drops a
    candidate — ``ids`` stays bit-identical with the stage off — it only
    tightens what verification sees: the serving engine prunes pairs
    whose LB exceeds the working radius from the worklist and seeds the
    survivors' A* with ``max(bound, lb)``.
    """

    ids: List[List[int]]
    bounds: List[Optional[np.ndarray]]     # aligned with ids
    lbs: Optional[List[Optional[np.ndarray]]] = None
    # per-query share of the assignment-LB wall time (seconds), for the
    # serving engine's stage breakdown (DESIGN.md §17); None when the
    # stage is off
    lb_s: Optional[List[float]] = None


def bucket_queries(partition: RegionPartition, graphs: Sequence[Graph],
                   taus: Sequence[int]) -> Dict[Rect, List[int]]:
    """Stage 1: query indices grouped by reduced-query-region rectangle."""
    buckets: Dict[Rect, List[int]] = {}
    for qi, (h, tau) in enumerate(zip(graphs, taus)):
        rect = partition.query_region(h.n, h.m, int(tau))
        buckets.setdefault(rect, []).append(qi)
    return buckets


class BatchedFilterEval:
    """Stages 2+3 (and 1.5): slab layout plus the leaf-level filter pass
    per bucket.

    Holds the database-side ``FilterSlab`` (built once in the configured
    layout, reused across batches) and evaluates the combined admissible
    bound for every (query, graph) pair of a bucket.  Candidate sets,
    bounds and LBs are bit-identical across backends and slab layouts.

    ``backend`` is ``cuda`` (the kernels; needs a CUDA device and raises
    without one), ``torch`` (the kernels' plain PyTorch versions on
    ``device``, the CUDA device unless the caller names another) or
    ``numpy`` (the host oracle).
    """

    def __init__(self, db: GraphDB, enc: EncodedDB,
                 partition: RegionPartition, backend: str = "cuda", *,
                 device=None, slab: str = "dense",
                 hot_d: Optional[int] = None,
                 device_cache_entries: int = 16, assign_lb: bool = True,
                 lb_hungarian: int = 0, faults=None):
        self.device = resolve_device(backend, device)
        self.backend = backend
        self.db = db
        self.enc = enc
        self.vocab = enc.vocab
        self.partition = partition
        self.slab = FilterSlab.build(db, enc, partition, layout=slab,
                                     hot_d=hot_d)
        self.slab_layout = self.slab.layout
        self.vmax = self.slab.vmax
        # per-bucket gathered sub-slabs + their device-resident operands
        # (DESIGN.md §13)
        self.device_cache = DeviceSlabCache(device_cache_entries)
        # stage 1.5: batched assignment lower bounds (DESIGN.md §16)
        self.assign_lb = bool(assign_lb)
        self.lb_hungarian = int(lb_hungarian)
        # fault injection (duck-typed: anything with .fire(point, **ctx))
        self.faults = None
        self.set_faults(faults)

    def set_faults(self, faults) -> None:
        """(Re)attach a fault injector; threads into the device cache so
        upload builds fire ``device.cache`` too.  ``None`` disarms."""
        self.faults = faults
        self.device_cache.set_faults(faults)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(
            self.device)

    def _gather_cached(self, idx: np.ndarray, n_pad: int):
        """(cache key, gathered sub-slab) for one bucket; the host gather
        is cached across batches alongside the device operands."""
        key = bucket_key(idx, n_pad)
        return key, self.device_cache.get_or_build(
            key, "sub", lambda: self.slab.gather(idx, n_pad))

    # ---- stage 1.5: batched assignment lower bounds (DESIGN.md §16) -------
    def bucket_assign_lbs(self, hs: Sequence[Graph],
                          cand_ids: Sequence[List[int]]
                          ) -> List[np.ndarray]:
        """Per-query assignment LBs aligned with each query's candidate
        list, computed in one batched pass over the bucket's *union* of
        surviving ids (post-filter survivors are a small fraction of the
        bucket, and coalescing the union keeps it one device launch)."""
        union = sorted(set().union(*(set(c) for c in cand_ids)))
        if not union:
            return [np.zeros(0, np.int64) for _ in cand_ids]
        uidx = np.asarray(union, np.int64)
        vmq = max((h.n for h in hs), default=1)
        qv, qd, qeh = branch_features(hs, self.db.n_elabels, max(vmq, 1))
        qn = np.asarray([h.n for h in hs], np.int32)
        lbm = self._assign_lb_matrix(uidx, qv, qd, qeh, qn)
        pos = {g: i for i, g in enumerate(union)}
        out = []
        for r, ids in enumerate(cand_ids):
            out.append(np.asarray(
                lbm[r, [pos[g] for g in ids]], np.int64))
        if self.lb_hungarian > 0:
            self._hungarian_refine(hs, cand_ids, out)
        return out

    def _hungarian_refine(self, hs, cand_ids, lbs) -> None:
        """Tighten the ``lb_hungarian`` highest-LB survivors per query
        with the exact assignment relaxation (still a provable bound, so
        still recall-safe) — the pairs closest to the radius are the ones
        an exact assignment is most likely to push over it."""
        slab = self.slab
        for r, (h, ids) in enumerate(zip(hs, cand_ids)):
            if not len(ids):
                continue
            hv, hd, heh = branch_features([h], self.db.n_elabels,
                                          max(h.n, 1))
            top = np.argsort(lbs[r], kind="stable")[-self.lb_hungarian:]
            for t in top:
                g = int(ids[int(t)])
                n = int(slab.nv[g])
                hung = lb_ops.hungarian_lb_pair(
                    hv[0][:h.n], hd[0][:h.n], heh[0][:h.n],
                    slab.bvlab[g][:n], slab.bdeg[g][:n], slab.behist[g][:n])
                if hung is not None:
                    lbs[r][int(t)] = max(int(lbs[r][int(t)]), hung)

    def _assign_lb_matrix(self, uidx: np.ndarray, qv, qd, qeh, qn
                          ) -> np.ndarray:
        """(Q, |union|) LB matrix on the configured backend.  All
        backends compute the same integers (the bound is provable and the
        paths share one padding contract), so downstream verification
        decisions are bit-identical across backends and layouts."""
        Q, N = len(qn), len(uidx)
        if self.backend == "numpy":
            _, sub = self._gather_cached(uidx, N)
            return lb_ops.assign_lb_np(qv, qd, qeh, qn, sub.bvlab, sub.bdeg,
                                       sub.behist, sub.nv)
        n_pad = qf_ops.shape_bucket(max(N, 1), lb_ops.N_BASE, lb_ops.N_CAP)
        key, sub = self._gather_cached(uidx, n_pad)
        db_side = self.device_cache.get_or_build(
            key, "lb_db",
            lambda: tuple(self._to_device(x) for x in
                          (sub.bvlab, sub.bdeg, sub.behist, sub.nv)))
        q_side = tuple(self._to_device(x) for x in
                       lb_ops.pad_query_block(qv, qd, qeh, qn))
        fn = (lb_kernel.assign_lb_call if self.backend == "cuda"
              else lb_ref.batched_assign_lb)
        with device_annotation("msq.assign_lb"):
            out = fn(*q_side, *db_side)
        return out[:Q, :N].cpu().numpy()

    # ---- query-side arrays ------------------------------------------------
    def query_arrays(self, h: Graph, tau: int,
                     qt: Optional[QueryTuple] = None) -> QueryArrays:
        return arrays.query_arrays_from_graph(h, self.vocab, self.partition,
                                              tau, self.vmax, qt=qt)

    def stack_queries(self, qs: Sequence[QueryArrays]) -> QueryArrays:
        """(Q, ...) stacked query arrays (leading axis = query)."""
        return QueryArrays(*[np.stack([np.asarray(getattr(q, f))
                                       for q in qs])
                             for f in QueryArrays._fields])

    def graphs_in_rect(self, rect: Rect) -> np.ndarray:
        return self.slab.in_rect(rect)

    # ---- the (Q, N) pass --------------------------------------------------
    def bounds(self, idx: np.ndarray,
               qs: Sequence[QueryArrays]) -> np.ndarray:
        """(Q, len(idx)) combined lower bounds for the bucket."""
        Q, N = len(qs), len(idx)
        if Q == 0 or N == 0:
            return np.zeros((Q, N), np.int32)
        if self.backend == "numpy":
            return self._bounds_np(idx, qs)
        if self.faults is not None:
            self.faults.fire("device.filter", backend=self.backend)
        return self._bounds_device(idx, qs)

    def bucket_candidates(self, idx: np.ndarray, qs: Sequence[QueryArrays],
                          taus: Sequence[int]
                          ) -> List[Tuple[List[int], np.ndarray]]:
        """Per-query (sorted candidate ids, aligned bounds) for one
        bucket, thresholding the (Q, N) bounds at each query's tau."""
        bounds = self.bounds(idx, qs)
        out: List[Tuple[List[int], np.ndarray]] = []
        for row in range(len(qs)):
            keep = bounds[row] <= int(taus[row])
            # idx is ascending (flatnonzero), so the kept ids stay sorted
            out.append(([int(g) for g in idx[keep]],
                        np.asarray(bounds[row][keep])))
        return out

    def _bounds_np(self, idx: np.ndarray,
                   qs: Sequence[QueryArrays]) -> np.ndarray:
        _, sub = self._gather_cached(idx, len(idx))
        db = sub.base_arrays()
        out = np.empty((len(qs), len(idx)), np.int64)
        for i, q in enumerate(qs):
            c_d = sub.cd_one(np.asarray(q.fd))
            b = filters.batched_bounds_np(
                db.nv, db.ne, db.degseq, db.vhist, db.ehist, c_d,
                int(q.nv), int(q.ne), np.asarray(q.sigma),
                np.asarray(q.vhist), np.asarray(q.ehist))
            out[i] = b["combined"]
        return out

    def _bounds_device(self, idx: np.ndarray,
                       qs: Sequence[QueryArrays]) -> np.ndarray:
        """One query-batched pass per bucket (DESIGN.md §13): the padded
        query block rides a leading Q axis and every db-side operand comes
        from the device-resident cache.  ``cuda`` launches the kernels,
        ``torch`` runs their plain versions on the same padded operands.
        On the packed slab the cache holds the bucket's packed rows, and
        every pass decodes them into the filter's zero-padded F_D block
        (the bit-unpack kernel, then the filter kernel)."""
        Q, N = len(qs), len(idx)
        n_pad = qf_ops.shape_bucket(max(N, 1), qf_ops.B_BASE, qf_ops.B_CAP)
        key, sub = self._gather_cached(idx, n_pad)
        cuda = self.backend == "cuda"
        if self.slab_layout == "packed":
            words, sb, widths = self.device_cache.get_or_build(
                key, "packed", lambda: tuple(
                    self._to_device(x) for x in
                    (sub.packed.words, sub.packed.sb, sub.packed.widths)))
            up = qf_ops.shape_bucket(sub.U, qf_ops.U_BASE, qf_ops.U_CAP)
            with device_annotation("msq.bitunpack"):
                fd = bu_ops.unpack_rows_device(
                    words, sb, widths, up,
                    fn=bu_kernel.bitunpack_call if cuda else bu_ref.bitunpack)
        else:
            fd = self.device_cache.get_or_build(
                key, "fd", lambda: qf_ops.upload_fd(sub.fd, self.device))

        def _upload_small():
            aux = np.stack([sub.nv, sub.ne, sub.region_i, sub.region_j],
                           axis=1)
            return tuple(self._to_device(x) for x in
                         (sub.vhist, sub.ehist, sub.degseq, aux))
        vhist, ehist, degseq, aux = self.device_cache.get_or_build(
            key, "small", _upload_small)

        qb = self.stack_queries(qs)
        cdt = None
        if self.slab_layout == "hot":
            # the CSR tail's C_D correction seeds the kernel's C_D
            # (DESIGN.md §3) — per (query, graph), so it is the one
            # db-side operand rebuilt per batch
            cdt = self._to_device(sub.tail_minsum_batch(qb.fd))
            qb = qb._replace(fd=qb.fd[:, :sub.hot_d])
        p = self.partition
        sc = qf_ops.make_scalars_batch(qs, p.x0, p.y0, p.l)
        fn = (qf_kernel.fused_batched_call if cuda
              else qf_ref.fused_batched_bounds)
        with device_annotation("msq.qgram_filter"):
            b, _ = qf_ops.fused_filter_bounds_batched(
                self._to_device(sc), fd, self._to_device(qb.fd), vhist,
                self._to_device(qb.vhist), ehist, self._to_device(qb.ehist),
                degseq, self._to_device(qb.sigma), aux, cdt, fn=fn)
        return b[:, :N].cpu().numpy()


def batched_flat_candidates(ev: BatchedFilterEval, graphs: Sequence[Graph],
                            taus: Sequence[int],
                            qtuples: Optional[Sequence[QueryTuple]] = None
                            ) -> CandidateBatch:
    """Stages 1-3 for a flat source: bucket, gather the slab, one filter
    pass per bucket, per-query candidate lists, then (when
    ``ev.assign_lb``) the stage-1.5 assignment LB pass over each bucket's
    surviving candidates (DESIGN.md §16)."""
    obs = current_obs()
    spans_on = obs is not None and obs.spans.enabled
    Qn = len(graphs)
    ids: List[List[int]] = [[] for _ in range(Qn)]
    bnds: List[Optional[np.ndarray]] = [None] * Qn
    lbs: Optional[List[Optional[np.ndarray]]] = \
        [None] * Qn if ev.assign_lb else None
    lb_s: Optional[List[float]] = [0.0] * Qn if ev.assign_lb else None
    t_b = time.perf_counter() if spans_on else 0.0
    buckets = bucket_queries(ev.partition, graphs, taus)
    if spans_on:
        obs.spans.record("bucket", t_b, time.perf_counter(),
                         n_queries=Qn, n_buckets=len(buckets))
    for rect, qis in buckets.items():
        idx = ev.graphs_in_rect(rect)
        if len(idx) == 0:
            for qi in qis:
                ids[qi] = []
                bnds[qi] = np.zeros(0, np.int64)
                if lbs is not None:
                    lbs[qi] = np.zeros(0, np.int64)
            continue
        qs = [ev.query_arrays(graphs[qi], int(taus[qi]),
                              None if qtuples is None else qtuples[qi])
              for qi in qis]
        t_f = time.perf_counter() if spans_on else 0.0
        cands = ev.bucket_candidates(idx, qs, [int(taus[qi]) for qi in qis])
        if spans_on:
            obs.spans.record("filter_bucket", t_f, time.perf_counter(),
                             n_queries=len(qis), n_graphs=int(len(idx)),
                             backend=ev.backend)
        for row, qi in enumerate(qis):
            ids[qi], bnds[qi] = cands[row]
        if lbs is not None:
            t0 = time.perf_counter()
            blbs = ev.bucket_assign_lbs([graphs[qi] for qi in qis],
                                        [cands[row][0]
                                         for row in range(len(qis))])
            t1 = time.perf_counter()
            if spans_on:
                obs.spans.record("assign_lb", t0, t1, n_queries=len(qis),
                                 n_pairs=sum(len(c[0]) for c in cands))
            share = (t1 - t0) / len(qis)
            for row, qi in enumerate(qis):
                lbs[qi] = blbs[row]
                lb_s[qi] = share
    return CandidateBatch(ids=ids, bounds=bnds, lbs=lbs, lb_s=lb_s)
