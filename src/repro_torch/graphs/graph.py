"""Attributed (labeled) simple undirected graphs.

The paper (Definition 1) works with labeled simple undirected graphs
without multi-edges or self-loops.  Vertex labels and edge labels are
small integers (a host-side vocabulary maps raw labels to ids).
"""
from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Graph:
    """A labeled simple undirected graph.

    Attributes:
      n: number of vertices (ids ``0..n-1``).
      vlabels: ``(n,)`` int32 vertex labels.
      edges: ``(m, 2)`` int32 endpoints with ``edges[i, 0] < edges[i, 1]``,
        lexicographically sorted, unique.
      elabels: ``(m,)`` int32 edge labels.
    """

    n: int
    vlabels: np.ndarray
    edges: np.ndarray
    elabels: np.ndarray

    def __post_init__(self) -> None:
        object.__setattr__(self, "vlabels", np.asarray(self.vlabels, np.int32))
        e = np.asarray(self.edges, np.int32).reshape(-1, 2)
        el = np.asarray(self.elabels, np.int32).reshape(-1)
        if e.shape[0] != el.shape[0]:
            raise ValueError("edges/elabels length mismatch")
        if self.vlabels.shape[0] != self.n:
            raise ValueError("vlabels length != n")
        if e.size:
            if (e[:, 0] == e[:, 1]).any():
                raise ValueError("self-loop")
            lo = np.minimum(e[:, 0], e[:, 1])
            hi = np.maximum(e[:, 0], e[:, 1])
            order = np.lexsort((hi, lo))
            e = np.stack([lo, hi], axis=1)[order]
            el = el[order]
            if e.shape[0] > 1:
                dup = (np.diff(e[:, 0]) == 0) & (np.diff(e[:, 1]) == 0)
                if dup.any():
                    raise ValueError("multi-edge")
            if e.size and (e.min() < 0 or e.max() >= self.n):
                raise ValueError("edge endpoint out of range")
        object.__setattr__(self, "edges", e)
        object.__setattr__(self, "elabels", el)

    # ---- basic accessors -------------------------------------------------
    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n, np.int32)
        if self.m:
            np.add.at(d, self.edges[:, 0], 1)
            np.add.at(d, self.edges[:, 1], 1)
        return d

    def degree_sequence(self) -> np.ndarray:
        """Non-increasing degree sequence (sigma_g in the paper)."""
        return np.sort(self.degrees())[::-1].astype(np.int32)

    def adjacency(self) -> List[List[Tuple[int, int]]]:
        """adj[v] = list of (neighbor, edge_label)."""
        adj: List[List[Tuple[int, int]]] = [[] for _ in range(self.n)]
        for (u, v), l in zip(self.edges, self.elabels):
            adj[int(u)].append((int(v), int(l)))
            adj[int(v)].append((int(u), int(l)))
        return adj

    def edge_label_dict(self) -> dict:
        return {(int(u), int(v)): int(l) for (u, v), l in zip(self.edges, self.elabels)}

    def vertex_label_hist(self, n_labels: int) -> np.ndarray:
        return np.bincount(self.vlabels, minlength=n_labels).astype(np.int32)

    def edge_label_hist(self, n_labels: int) -> np.ndarray:
        if self.m == 0:
            return np.zeros(n_labels, np.int32)
        return np.bincount(self.elabels, minlength=n_labels).astype(np.int32)

    def relabel_vertices(self, perm: Sequence[int]) -> "Graph":
        """Return an isomorphic graph with vertex ``i`` renamed ``perm[i]``."""
        perm = np.asarray(perm, np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n, dtype=np.int32)
        vl = np.empty_like(self.vlabels)
        vl[perm] = self.vlabels
        e = perm[self.edges] if self.m else self.edges
        return Graph(self.n, vl, e, self.elabels)

    def __hash__(self) -> int:  # structural hash (not isomorphism-invariant)
        return hash(
            (self.n, self.vlabels.tobytes(), self.edges.tobytes(), self.elabels.tobytes())
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Graph):
            return NotImplemented
        return (
            self.n == other.n
            and np.array_equal(self.vlabels, other.vlabels)
            and np.array_equal(self.edges, other.edges)
            and np.array_equal(self.elabels, other.elabels)
        )


class GraphDB:
    """An ordered collection of graphs + label vocabularies.

    This is the ``G`` of the problem statement.  It also records
    ``n_vlabels`` / ``n_elabels`` (the global label alphabets) which the
    filters need for histogram intersections.
    """

    def __init__(self, graphs: Sequence[Graph], n_vlabels: Optional[int] = None,
                 n_elabels: Optional[int] = None):
        self.graphs: List[Graph] = list(graphs)
        if n_vlabels is None:
            n_vlabels = 1 + max((int(g.vlabels.max()) for g in self.graphs if g.n), default=0)
        if n_elabels is None:
            n_elabels = 1 + max((int(g.elabels.max()) for g in self.graphs if g.m), default=0)
        self.n_vlabels = int(n_vlabels)
        self.n_elabels = int(n_elabels)

    def __len__(self) -> int:
        return len(self.graphs)

    def __getitem__(self, i: int) -> Graph:
        return self.graphs[i]

    def __iter__(self) -> Iterator[Graph]:
        return iter(self.graphs)

    # ---- bulk stats ------------------------------------------------------
    def sizes(self) -> Tuple[np.ndarray, np.ndarray]:
        nv = np.array([g.n for g in self.graphs], np.int32)
        ne = np.array([g.m for g in self.graphs], np.int32)
        return nv, ne

    def stats(self) -> dict:
        nv, ne = self.sizes()
        return {
            "num_graphs": len(self.graphs),
            "avg_V": float(nv.mean()) if len(self.graphs) else 0.0,
            "avg_E": float(ne.mean()) if len(self.graphs) else 0.0,
            "max_V": int(nv.max()) if len(self.graphs) else 0,
            "max_E": int(ne.max()) if len(self.graphs) else 0,
            "n_vlabels": self.n_vlabels,
            "n_elabels": self.n_elabels,
        }

    # ---- serialization ---------------------------------------------------
    def save(self, path: str) -> None:
        """Single-file npz serialization (CSR-style concatenation)."""
        nv, ne = self.sizes()
        voff = np.concatenate([[0], np.cumsum(nv)]).astype(np.int64)
        eoff = np.concatenate([[0], np.cumsum(ne)]).astype(np.int64)
        vlab = (np.concatenate([g.vlabels for g in self.graphs])
                if len(self.graphs) else np.zeros(0, np.int32))
        edges = (np.concatenate([g.edges for g in self.graphs])
                 if any(g.m for g in self.graphs) else np.zeros((0, 2), np.int32))
        elab = (np.concatenate([g.elabels for g in self.graphs])
                if any(g.m for g in self.graphs) else np.zeros(0, np.int32))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(
            path, voff=voff, eoff=eoff, vlab=vlab, edges=edges, elab=elab,
            meta=np.array([self.n_vlabels, self.n_elabels], np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "GraphDB":
        z = np.load(path)
        voff, eoff = z["voff"], z["eoff"]
        graphs = []
        for i in range(len(voff) - 1):
            vl = z["vlab"][voff[i]:voff[i + 1]]
            e = z["edges"][eoff[i]:eoff[i + 1]]
            el = z["elab"][eoff[i]:eoff[i + 1]]
            graphs.append(Graph(len(vl), vl, e, el))
        meta = z["meta"]
        return cls(graphs, int(meta[0]), int(meta[1]))
