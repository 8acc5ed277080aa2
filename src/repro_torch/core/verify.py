"""Exact graph edit distance — the verification phase (Section 6.2).

``ged_upto(g, h, tau)`` is the production entry point: A* over vertex
mappings with an admissible label-count heuristic and an f-cost cutoff at
``tau`` (verification only needs to decide ged <= tau; the cutoff keeps the
NP-hard search tractable for the candidate sets the filters leave).
Returns the exact GED if <= tau, else ``tau + 1``.

``GEDSearch`` is the resumable form the serving worklist uses
(DESIGN.md §12): one instance holds the A* frontier for one
(db graph, query, tau) pair, and ``run`` accepts an expansion budget
and/or a wall-clock deadline — an undecided search keeps its heap and a
later ``run`` continues exactly where it stopped, so verifier workers can
timeslice expensive pairs and honor per-query deadlines without losing
work.  ``min_f`` exposes the frontier's cheapest f-cost, the honest
worklist priority of a partially-run search.

``ged_exact`` runs without cutoff (tiny graphs / tests).
``ged_bruteforce`` is an independent oracle by exhaustive enumeration over
padded vertex bijections (tests only).

Cost model (the paper's six primitives, unit costs): vertex ins/del/sub,
edge ins/del/sub; substitution is free when labels match.
"""
from __future__ import annotations

import heapq
import itertools
import os
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graphs.graph import Graph

INF = 10 ** 9


def _edge_dict(g: Graph) -> Dict[Tuple[int, int], int]:
    return {(int(u), int(v)): int(l) for (u, v), l in zip(g.edges, g.elabels)}


def _order_query_vertices(h: Graph) -> List[int]:
    """Connectivity-aware, high-degree-first processing order."""
    if h.n == 0:
        return []
    deg = h.degrees()
    adj = [set() for _ in range(h.n)]
    for (u, v) in h.edges:
        adj[int(u)].add(int(v))
        adj[int(v)].add(int(u))
    order: List[int] = []
    seen = set()
    while len(order) < h.n:
        # seed: highest-degree unseen vertex
        cand = [v for v in range(h.n) if v not in seen]
        seed = max(cand, key=lambda v: deg[v])
        frontier = [seed]
        seen.add(seed)
        order.append(seed)
        while True:
            nbrs = sorted(
                {w for v in order for w in adj[v] if w not in seen},
                key=lambda v: -deg[v])
            if not nbrs:
                break
            v = nbrs[0]
            seen.add(v)
            order.append(v)
    return order


def _heuristic(g: Graph, h: Graph, order: List[int], k: int,
               used_g: int, vlab_h_rem: Counter, elab_h_rem: Counter,
               g_vlab_all: Counter, g_elab_all: Counter,
               mapped_g_vlab: Counter, scored_g_edges: Counter) -> int:
    """Admissible label-count estimate of the remaining cost."""
    n_h_rem = h.n - k
    n_g_rem = g.n - bin(used_g).count("1")
    g_vlab_rem = g_vlab_all - mapped_g_vlab
    ov_v = sum(min(vlab_h_rem[l], g_vlab_rem[l]) for l in vlab_h_rem)
    v_cost = max(n_h_rem, n_g_rem) - ov_v
    e_h_rem = sum(elab_h_rem.values())
    g_elab_rem = g_elab_all - scored_g_edges
    e_g_rem = sum(g_elab_rem.values())
    ov_e = sum(min(elab_h_rem[l], g_elab_rem[l]) for l in elab_h_rem)
    e_cost = max(e_h_rem, e_g_rem) - ov_e
    return max(v_cost, 0) + max(e_cost, 0)


class GEDSearch:
    """Resumable, budgeted A* deciding ``ged(g, h) <= tau`` (DESIGN.md §12).

    ``run`` pops frontier states until the search decides, the expansion
    budget runs out, or the wall-clock deadline passes; an undecided run
    returns ``None`` and a later ``run`` resumes from the saved heap.  The
    decision (exact GED if <= tau, else ``tau + 1``) is identical to the
    unbudgeted search regardless of how the work was sliced.
    """

    __slots__ = ("g", "h", "tau", "lb", "order", "h_edges", "g_edges",
                 "g_vlab_all", "g_elab_all", "vlab_suffix", "elab_suffix",
                 "heap", "result", "expansions")

    def __init__(self, g: Graph, h: Graph, tau: int, *,
                 initial_bound: int = 0):
        """``initial_bound`` is an externally proven GED lower bound (the
        stage-1.5 assignment LB, DESIGN.md §16): ``initial_bound > tau``
        decides ``tau + 1`` with zero expansions, and ``min_f`` never
        reports below it — the search's own frontier usually starts
        looser, so the seeded bound keeps the worklist priority honest.
        Decisions are unchanged: a provable bound can only shortcut work
        A* would have done anyway."""
        self.g, self.h, self.tau = g, h, int(tau)
        self.lb = int(initial_bound)
        tau = self.tau
        self.order = order = _order_query_vertices(h)
        self.h_edges = h_edges = _edge_dict(h)
        self.g_edges = _edge_dict(g)
        self.g_vlab_all = Counter(int(x) for x in g.vlabels)
        self.g_elab_all = Counter(int(x) for x in g.elabels)

        # per-depth remaining h label multisets (precomputed suffix counters)
        vlab_suffix: List[Counter] = [Counter() for _ in range(h.n + 1)]
        for k in range(h.n - 1, -1, -1):
            vlab_suffix[k] = vlab_suffix[k + 1].copy()
            vlab_suffix[k][int(h.vlabels[order[k]])] += 1
        # h edges become "scored" when their second endpoint is processed
        pos_in_order = {v: i for i, v in enumerate(order)}
        elab_suffix: List[Counter] = [Counter() for _ in range(h.n + 1)]
        for k in range(h.n - 1, -1, -1):
            elab_suffix[k] = elab_suffix[k + 1].copy()
            for (a, b), l in h_edges.items():
                if max(pos_in_order[a], pos_in_order[b]) == k:
                    elab_suffix[k][l] += 1
        self.vlab_suffix, self.elab_suffix = vlab_suffix, elab_suffix

        self.expansions = 0
        self.result: Optional[int] = None
        self.heap: list = []
        start_h = _heuristic(g, h, order, 0, 0, vlab_suffix[0],
                             elab_suffix[0], self.g_vlab_all,
                             self.g_elab_all, Counter(), Counter())
        if max(start_h, self.lb) > tau:
            self.result = tau + 1
        elif h.n == 0:
            c = self._completion_cost(0)
            self.result = c if c <= tau else tau + 1
        else:
            # state: (f, cost, depth, used_g bitmask, mapping tuple)
            self.heap = [(start_h, 0, 0, 0, ())]

    @property
    def done(self) -> bool:
        return self.result is not None

    def min_f(self) -> int:
        """Best lower bound on the final answer so far: the decision when
        done, else the frontier's cheapest f-cost (the honest worklist
        priority of a partially-run search)."""
        if self.result is not None:
            return self.result
        f = self.heap[0][0] if self.heap else self.tau + 1
        return max(f, self.lb)

    def frontier(self) -> Tuple[int, int]:
        """``(expansions, open_nodes)`` — where a paused search stands.

        Used by the scheduler's pool-recovery path (and its tests) to
        assert that a re-enqueued search resumes from its last frontier
        instead of restarting from scratch."""
        return self.expansions, len(self.heap)

    def _completion_cost(self, used_g: int) -> int:
        """Insert the unmatched g vertices and all their incident edges."""
        rem = [v for v in range(self.g.n) if not (used_g >> v) & 1]
        total = len(rem)
        rem_set = set(rem)
        for (a, b) in self.g_edges:
            if a in rem_set or b in rem_set:
                total += 1
        return total

    def run(self, max_expansions: Optional[int] = None,
            deadline: Optional[float] = None) -> Optional[int]:
        """Continue the search.  Returns the decision (exact GED if <= tau,
        else ``tau + 1``), or ``None`` when the budget/deadline ran out
        first (call ``run`` again to resume)."""
        if self.result is not None:
            return self.result
        g, h, tau = self.g, self.h, self.tau
        order, h_edges, g_edges = self.order, self.h_edges, self.g_edges
        g_vlab_all, g_elab_all = self.g_vlab_all, self.g_elab_all
        vlab_suffix, elab_suffix = self.vlab_suffix, self.elab_suffix
        heap = self.heap
        popped = 0
        while heap:
            if max_expansions is not None and popped >= max_expansions:
                return None
            if deadline is not None and time.perf_counter() >= deadline:
                return None
            f, cost, k, used_g, mapping = heapq.heappop(heap)
            popped += 1
            self.expansions += 1
            if f > tau:
                self.result = tau + 1
                return self.result
            if k == h.n:
                self.result = cost  # completion cost folded in at push time
                return self.result
            u = order[k]
            lu = int(h.vlabels[u])
            # counters describing already-scored material (for the heuristic)
            mapped_g_vlab = Counter(int(g.vlabels[v])
                                    for v in mapping if v >= 0)
            scored_g_edges: Counter = Counter()
            mapped_pairs = [(order[i], mapping[i]) for i in range(k)
                            if mapping[i] >= 0]
            for i in range(len(mapped_pairs)):
                for j in range(i + 1, len(mapped_pairs)):
                    va, vb = mapped_pairs[i][1], mapped_pairs[j][1]
                    a, b = (va, vb) if va < vb else (vb, va)
                    if (a, b) in g_edges:
                        scored_g_edges[g_edges[(a, b)]] += 1

            def edge_delta(v: int) -> int:
                d = 0
                for i in range(k):
                    uj, vj = order[i], mapping[i]
                    a, b = (u, uj) if u < uj else (uj, u)
                    hl = h_edges.get((a, b))
                    if v < 0 or vj < 0:
                        if hl is not None:
                            d += 1  # edge to a deleted endpoint gets deleted
                        continue
                    ga, gb = (v, vj) if v < vj else (vj, v)
                    gl = g_edges.get((ga, gb))
                    if hl is not None and gl is not None:
                        d += int(hl != gl)
                    elif hl is not None or gl is not None:
                        d += 1
                return d

            children = []
            for v in range(g.n):
                if (used_g >> v) & 1:
                    continue
                c = cost + int(lu != int(g.vlabels[v])) + edge_delta(v)
                children.append((c, v))
            children.append((cost + 1 + edge_delta(-1), -1))  # deletion

            for c, v in children:
                if c > tau:
                    continue
                new_used = used_g | (1 << v) if v >= 0 else used_g
                new_mapping = mapping + (v,)
                m_vlab = mapped_g_vlab.copy()
                s_edges = scored_g_edges.copy()
                if v >= 0:
                    m_vlab[int(g.vlabels[v])] += 1
                    for i in range(k):
                        vj = mapping[i]
                        if vj >= 0:
                            a, b = (v, vj) if v < vj else (vj, v)
                            if (a, b) in g_edges:
                                s_edges[g_edges[(a, b)]] += 1
                if k + 1 == h.n:
                    total = c + self._completion_cost(new_used)
                    if total <= tau:
                        heapq.heappush(heap, (total, total, k + 1, new_used,
                                              new_mapping))
                    continue
                hh = _heuristic(g, h, order, k + 1, new_used,
                                vlab_suffix[k + 1], elab_suffix[k + 1],
                                g_vlab_all, g_elab_all, m_vlab, s_edges)
                if c + hh <= tau:
                    heapq.heappush(heap, (c + hh, c, k + 1, new_used,
                                          new_mapping))
        self.result = tau + 1
        return self.result


def run_search_slice(search: GEDSearch, max_expansions: Optional[int],
                     deadline: Optional[float], want_span: bool = False):
    """One worker-side A* timeslice: run the (picklable) search and send
    it back with its decision — the ``VerifyScheduler`` process-pool
    executor's unit of work (DESIGN.md §12).  The returned search carries
    the advanced frontier, so an undecided slice resumes exactly like the
    in-process path.  ``deadline`` stays comparable across processes
    because ``time.perf_counter`` is CLOCK_MONOTONIC (system-wide) on the
    Linux hosts the pool runs on — which is also what lets the
    ``want_span`` timing fragment ``(t0, t1, pid)`` land on the host
    span timeline (DESIGN.md §17) without clock translation."""
    if not want_span:
        d = search.run(max_expansions=max_expansions, deadline=deadline)
        return d, search
    t0 = time.perf_counter()
    d = search.run(max_expansions=max_expansions, deadline=deadline)
    t1 = time.perf_counter()
    return d, search, (t0, t1, os.getpid())


def ged_upto(g: Graph, h: Graph, tau: int, *,
             max_expansions: Optional[int] = None,
             deadline: Optional[float] = None) -> Optional[int]:
    """Exact GED if <= tau, else tau + 1.  A* with cutoff pruning.

    With a budget (``max_expansions`` heap pops and/or an absolute
    ``deadline`` from ``time.perf_counter()``), returns ``None`` when the
    budget ran out before the search decided — resume via ``GEDSearch``.
    """
    return GEDSearch(g, h, tau).run(max_expansions=max_expansions,
                                    deadline=deadline)


def ged_exact(g: Graph, h: Graph) -> int:
    """Exact GED without a caller-supplied cutoff (tiny graphs only).

    Iterative deepening keeps the cutoff pruning of ``ged_upto`` effective.
    """
    tau = 0
    hi = g.n + h.n + g.m + h.m  # delete everything, insert everything
    while tau <= hi:
        r = ged_upto(g, h, tau)
        if r <= tau:
            return r
        tau = max(tau + 1, min(2 * max(tau, 1), hi))
    return hi


def ged_bruteforce(g: Graph, h: Graph) -> int:
    """Independent exhaustive oracle (pads with epsilon vertices)."""
    n_g, n_h = g.n, h.n
    g_edges = _edge_dict(g)
    h_edges = _edge_dict(h)
    best = INF
    # images: injective map from h vertices to g vertices or eps (-1)
    g_slots = list(range(n_g)) + [-1] * n_h
    seen = set()
    for perm in itertools.permutations(g_slots, n_h):
        if perm in seen:
            continue
        seen.add(perm)
        cost = 0
        for u in range(n_h):
            v = perm[u]
            if v < 0:
                cost += 1
            elif int(h.vlabels[u]) != int(g.vlabels[v]):
                cost += 1
        used = {v for v in perm if v >= 0}
        cost += n_g - len(used)  # inserted g vertices
        # h edges
        for (a, b), hl in h_edges.items():
            va, vb = perm[a], perm[b]
            if va < 0 or vb < 0:
                cost += 1
                continue
            x, y = (va, vb) if va < vb else (vb, va)
            gl = g_edges.get((x, y))
            cost += 1 if gl is None else int(gl != hl)
        # g edges with no h counterpart
        inv = {v: u for u, v in enumerate(perm) if v >= 0}
        for (x, y) in g_edges:
            if x in inv and y in inv:
                a, b = inv[x], inv[y]
                a, b = (a, b) if a < b else (b, a)
                if (a, b) not in h_edges:
                    cost += 1
            else:
                cost += 1
        best = min(best, cost)
    return best
