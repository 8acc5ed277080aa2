"""Dataset generators.

The container has no network access, so the AIDS / PubChem / GraphGen
datasets of the paper are replaced by statistically matched synthetic
generators (see DESIGN.md §9):

* ``aids_like_db`` — molecule-like sparse graphs: |V| ~ N(25.6, 8), edge
  count ≈ 1.07·|V| (ring-and-tree chemistry), 62 vertex labels drawn from
  a Zipf distribution (C/N/O dominate real molecules), 3 edge labels
  (single/double/triple bonds, heavily skewed to single).
* ``graphgen_db`` — the GraphGen parameterisation used for
  S100K.E30.D50.L5: fixed edge count, target density ρ = 2|E|/(|V|(|V|−1)),
  uniform labels.
* ``perturb_graph`` — applies ≤ k random edit operations, giving pairs with
  a *known upper bound* on GED (used by tests and query workloads).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graphs.graph import Graph, GraphDB


def _zipf_probs(k: int, s: float = 1.3) -> np.ndarray:
    w = 1.0 / np.arange(1, k + 1) ** s
    return w / w.sum()


def random_graph(rng: np.random.Generator, n: int, m: int, n_vlabels: int,
                 n_elabels: int, vlabel_probs: Optional[np.ndarray] = None,
                 elabel_probs: Optional[np.ndarray] = None,
                 connected: bool = True,
                 max_degree: Optional[int] = None) -> Graph:
    """Uniform-ish random simple graph with ``n`` vertices and ``m`` edges.

    ``max_degree`` caps vertex degrees (chemistry valence; also controls
    degree-q-gram diversity in the AIDS-like generator)."""
    n = max(int(n), 1)
    max_m = n * (n - 1) // 2
    if max_degree is not None:
        max_m = min(max_m, n * max_degree // 2)
    m = int(min(max(m, 0), max_m))
    vlabels = rng.choice(n_vlabels, size=n, p=vlabel_probs).astype(np.int32)
    chosen: set = set()
    edges: List[Tuple[int, int]] = []
    deg = np.zeros(n, np.int32)

    def can(u: int, v: int) -> bool:
        if max_degree is None:
            return True
        return deg[u] < max_degree and deg[v] < max_degree

    if connected and n > 1 and m >= n - 1:
        # random spanning tree first (random attachment, degree-capped)
        perm = rng.permutation(n)
        for i in range(1, n):
            u = int(perm[i])
            for _try in range(16):
                v = int(perm[rng.integers(0, i)])
                if can(u, v):
                    break
            a, b = (u, v) if u < v else (v, u)
            if (a, b) in chosen:
                continue
            chosen.add((a, b))
            edges.append((a, b))
            deg[u] += 1
            deg[v] += 1
    tries = 0
    while len(edges) < m and tries < 50 * m + 100:
        tries += 1
        u = int(rng.integers(0, n))
        v = int(rng.integers(0, n))
        if u == v or not can(u, v):
            continue
        a, b = (u, v) if u < v else (v, u)
        if (a, b) in chosen:
            continue
        chosen.add((a, b))
        edges.append((a, b))
        deg[u] += 1
        deg[v] += 1
    e = np.array(edges, np.int32).reshape(-1, 2)
    el = rng.choice(n_elabels, size=len(edges), p=elabel_probs).astype(np.int32)
    return Graph(n, vlabels, e, el)


def aids_like_db(num_graphs: int, seed: int = 0, mean_v: float = 25.6,
                 std_v: float = 8.0, n_vlabels: int = 62,
                 n_elabels: int = 3, family_size: int = 4) -> GraphDB:
    """Molecule-like dataset statistically matched to AIDS (Table 1).

    Real compound databases contain congeneric series (families of close
    analogues), which is what makes similarity search non-trivial:
    ``family_size`` graphs per base molecule are emitted as small edit
    perturbations of each other, so GED neighbourhoods are populated.
    """
    rng = np.random.default_rng(seed)
    vprobs = _zipf_probs(n_vlabels, 1.6)      # C/N/O-like dominance
    eprobs = np.array([0.85, 0.13, 0.02])[:n_elabels]
    eprobs = eprobs / eprobs.sum()
    graphs: List[Graph] = []
    while len(graphs) < num_graphs:
        n = int(np.clip(round(rng.normal(mean_v, std_v)), 4, 64))
        # chemistry: |E| slightly above |V|-1 (rings): AIDS has E/V ≈ 1.074,
        # valence caps degrees at 4
        extra = rng.binomial(max(n // 6, 1), 0.55)
        m = (n - 1) + extra
        base = random_graph(rng, n, m, n_vlabels, n_elabels, vprobs,
                            eprobs, max_degree=4)
        graphs.append(base)
        for _ in range(min(family_size - 1, num_graphs - len(graphs))):
            k = int(rng.integers(1, 5))
            graphs.append(perturb_graph(base, k, rng, n_vlabels, n_elabels))
    perm = rng.permutation(len(graphs))
    return GraphDB([graphs[i] for i in perm], n_vlabels, n_elabels)


def graphgen_db(num_graphs: int, num_edges: int = 30, density: float = 0.5,
                n_vlabels: int = 5, n_elabels: int = 2, seed: int = 0) -> GraphDB:
    """GraphGen-style dataset, e.g. S100K.E30.D50.L5 = (100k, 30, 0.5, 5, 2).

    ρ = 2|E| / (|V|(|V|−1))  ⇒  |V| ≈ (1 + sqrt(1 + 8|E|/ρ)) / 2.
    """
    rng = np.random.default_rng(seed)
    n_target = (1.0 + np.sqrt(1.0 + 8.0 * num_edges / density)) / 2.0
    graphs = []
    for _ in range(num_graphs):
        n = int(np.clip(round(rng.normal(n_target, 0.75)), 3, 64))
        graphs.append(random_graph(rng, n, num_edges, n_vlabels, n_elabels,
                                   connected=False))
    return GraphDB(graphs, n_vlabels, n_elabels)


def perturb_graph(g: Graph, k: int, rng: np.random.Generator,
                  n_vlabels: int, n_elabels: int) -> Graph:
    """Apply exactly ``k`` random primitive edit operations to ``g``.

    Returns a graph ``h`` with ``ged(g, h) <= k`` (each op is one of the six
    primitives of the paper; the sequence may partially cancel, so the true
    GED can be smaller — tests use this as an upper bound only).
    """
    n = g.n
    vlabels = g.vlabels.copy().tolist()
    edict = {(int(u), int(v)): int(l) for (u, v), l in zip(g.edges, g.elabels)}
    for _ in range(k):
        ops = ["vsub", "esub", "eins", "edel", "vins", "vdel"]
        rng.shuffle(ops)
        for op in ops:
            if op == "vsub" and n > 0:
                v = int(rng.integers(0, n))
                new = int(rng.integers(0, n_vlabels))
                if new != vlabels[v]:
                    vlabels[v] = new
                    break
            elif op == "esub" and edict:
                key = list(edict)[int(rng.integers(0, len(edict)))]
                new = int(rng.integers(0, n_elabels))
                if new != edict[key]:
                    edict[key] = new
                    break
            elif op == "eins" and n >= 2:
                for _try in range(10):
                    u = int(rng.integers(0, n)); v = int(rng.integers(0, n))
                    if u == v:
                        continue
                    a, b = (u, v) if u < v else (v, u)
                    if (a, b) not in edict:
                        edict[(a, b)] = int(rng.integers(0, n_elabels))
                        break
                else:
                    continue
                break
            elif op == "edel" and edict:
                key = list(edict)[int(rng.integers(0, len(edict)))]
                del edict[key]
                break
            elif op == "vins":
                vlabels.append(int(rng.integers(0, n_vlabels)))
                n += 1
                break
            elif op == "vdel" and n > 1:
                # only isolated vertices can be deleted by one primitive op
                deg = np.zeros(n, np.int64)
                for (a, b) in edict:
                    deg[a] += 1
                    deg[b] += 1
                iso = np.flatnonzero(deg == 0)
                if len(iso) == 0:
                    continue
                v = int(iso[int(rng.integers(0, len(iso)))])
                vlabels.pop(v)
                remap = {}
                for old in range(n):
                    if old == v:
                        continue
                    remap[old] = old - (1 if old > v else 0)
                edict = {(remap[a], remap[b]): l for (a, b), l in edict.items()}
                n -= 1
                break
    edges = np.array(sorted(edict), np.int32).reshape(-1, 2)
    elabels = np.array([edict[tuple(e)] for e in edges], np.int32)
    return Graph(n, np.array(vlabels, np.int32), edges, elabels)
