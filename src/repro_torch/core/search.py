"""The flat filter-and-verify engine (Algorithm 2 without the tree).

Build:   GraphDB -> q-gram vocab -> region partition -> per-graph arrays.
Query:   reduced query region Q_h (formula (1)) -> leaf-level filters over
         the region's graphs -> candidate ids -> exact GED verification
         (ged_upto with tau cutoff).

``FlatMSQIndex`` evaluates every leaf-level filter for every graph in the
reduced query region, so its candidate sets equal the q-gram tree's (the
tree only prunes with *weaker* bounds than the leaves re-check).  Batches
go through ``BatchedFilterEval`` on the ``cuda`` backend unless the caller
asks for ``torch`` (on a named device) or ``numpy``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import filters
from repro_torch.core.engine import (BatchedFilterEval, CandidateBatch,
                                     batched_flat_candidates)
from repro_torch.core.qgrams import (EncodedDB, QGramVocab,
                                     sparse_intersection_size)
from repro_torch.core.region import default_partition
from repro_torch.core.slab import DEFAULT_HOT_D, hot_d_from_mass
from repro_torch.core.tree import QueryTuple
from repro_torch.core.verify import ged_upto
from repro_torch.graphs.batching import PaddedGraphBatch
from repro_torch.graphs.graph import Graph, GraphDB


@dataclass
class QueryResult:
    candidates: List[int]
    matches: List[Tuple[int, int]]          # (graph_id, ged)
    n_filtered: int                         # graphs pruned by the index
    filter_time_s: float
    verify_time_s: float
    stats: Dict[str, int] = field(default_factory=dict)


class FlatMSQIndex:
    """Tree-free vectorised MSQ index.

    All leaf-level filters evaluated for every graph in the reduced query
    region; equivalent candidate sets to the q-gram tree index because
    the tree only prunes with *weaker* bounds than the leaves re-check.
    """

    def __init__(self, db: GraphDB, l: int = 4,
                 vocab: Optional[QGramVocab] = None):
        t0 = time.perf_counter()
        self.db = db
        self.enc = EncodedDB.build(db, vocab)
        self.vocab = self.enc.vocab
        self.nv, self.ne = db.sizes()
        self.partition = default_partition(self.nv, self.ne, l=l)
        ri, rj = self.partition.region_of(self.nv, self.ne)
        self.region_i, self.region_j = ri, rj
        vmax = int(max(self.nv.max(), 1))
        self.batch = PaddedGraphBatch.from_db(db, vmax=vmax)
        self._filter_evals: Dict = {}
        self._hot_mass_widths: Dict[float, int] = {}
        self.build_time_s = time.perf_counter() - t0

    # ---- CandidateSource protocol -----------------------------------------
    def candidate_ids(self, h: Graph, tau: int) -> List[int]:
        return self.candidates(h, tau)

    def filter_eval(self, backend: str = "cuda", device=None,
                    slab: str = "dense", hot_d: Optional[int] = None,
                    hot_mass: Optional[float] = None, assign_lb: bool = True,
                    lb_hungarian: int = 0) -> BatchedFilterEval:
        """The batched (Q, N) filter evaluator over this index's arrays
        (built lazily once per backend x device x FilterSlab layout, then
        reused across batches — DESIGN.md §11).  ``slab`` is 'dense',
        'hot' or 'packed'.  ``backend='cuda'`` raises without a CUDA
        device; the CPU takes ``backend='torch', device='cpu'`` or
        ``backend='numpy'``."""
        if slab == "hot" and hot_d is None:
            # resolve hot_mass to a width up front so a mass-tuned and an
            # explicit hot_d evaluator of the same H share a cache entry;
            # memoized — the selector scans the whole encoded DB
            if hot_mass is not None:
                if hot_mass not in self._hot_mass_widths:
                    self._hot_mass_widths[hot_mass] = hot_d_from_mass(
                        self.enc, hot_mass)
                hot_d = self._hot_mass_widths[hot_mass]
            else:
                hot_d = DEFAULT_HOT_D
        elif slab != "hot":
            hot_d = None              # meaningless off-hot; don't fork keys
        # assign_lb / lb_hungarian fork the key: they change what the
        # evaluator computes per batch (the stage-1.5 LB pass, §16)
        key = (backend, None if device is None else str(device), slab,
               hot_d, bool(assign_lb), int(lb_hungarian))
        if key not in self._filter_evals:
            self._filter_evals[key] = BatchedFilterEval(
                self.db, self.enc, self.partition, backend, device=device,
                slab=slab, hot_d=hot_d, assign_lb=assign_lb,
                lb_hungarian=lb_hungarian)
        return self._filter_evals[key]

    def batched_candidates(self, graphs: Sequence[Graph],
                           taus: Sequence[int],
                           qtuples: Optional[Sequence[QueryTuple]] = None,
                           backend: str = "cuda", device=None,
                           slab: str = "dense", hot_d: Optional[int] = None,
                           hot_mass: Optional[float] = None,
                           assign_lb: bool = True, lb_hungarian: int = 0,
                           faults=None) -> CandidateBatch:
        ev = self.filter_eval(backend, device=device, slab=slab,
                              hot_d=hot_d, hot_mass=hot_mass,
                              assign_lb=assign_lb, lb_hungarian=lb_hungarian)
        if faults is not ev.faults:
            # the serving engine's injector rides along per call: the
            # evaluator is shared across engines (one per backend/slab
            # key), so attach rather than forking the cache key
            ev.set_faults(faults)
        return batched_flat_candidates(ev, graphs, taus, qtuples)

    def candidates(self, h: Graph, tau: int) -> List[int]:
        """One query's candidates on the host: the scalar-path oracle the
        batched backends are held against."""
        i1, i2, j1, j2 = self.partition.query_region(h.n, h.m, tau)
        in_region = ((self.region_i >= i1) & (self.region_i <= i2)
                     & (self.region_j >= j1) & (self.region_j <= j2))
        idx = np.flatnonzero(in_region)
        if len(idx) == 0:
            return []
        q = QueryTuple.from_graph(h, self.vocab)
        c_d = np.array([
            sparse_intersection_size(*self.enc.row_degree(int(g)),
                                     q.d_ids, q.d_cnt) for g in idx
        ], np.int64)
        vmax = self.batch.vmax
        q_sigma = np.zeros(vmax, np.int64)
        q_sigma[:min(h.n, vmax)] = q.sigma[:vmax]
        b = self.batch
        bounds = filters.batched_bounds_np(
            b.nv[idx], b.ne[idx], b.degseq[idx], b.vlabel_hist[idx],
            b.elabel_hist[idx], c_d, h.n, h.m, q_sigma,
            h.vertex_label_hist(self.vocab.n_vlabels),
            h.edge_label_hist(self.vocab.n_elabels))
        keep = bounds["combined"] <= tau
        return sorted(int(g) for g in idx[keep])

    def query(self, h: Graph, tau: int, verify: bool = True) -> QueryResult:
        t0 = time.perf_counter()
        cand = self.candidates(h, tau)
        t1 = time.perf_counter()
        matches = []
        if verify:
            for gid in cand:
                d = ged_upto(self.db[gid], h, tau)
                if d <= tau:
                    matches.append((gid, d))
        t2 = time.perf_counter()
        return QueryResult(cand, matches, len(self.db) - len(cand),
                           t1 - t0, t2 - t1)
