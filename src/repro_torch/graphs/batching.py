"""Padded dense batch views of a GraphDB for the vectorised (JAX) paths.

The succinct host index (repro_torch.core.succinct) is the archival format; the
accelerator path consumes fixed-shape padded arrays (DESIGN.md §3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.graphs.graph import Graph, GraphDB


@dataclass
class PaddedGraphBatch:
    """Fixed-shape arrays describing ``B`` graphs.

    All pads use 0 counts / -1 ids so reductions are mask-free where
    possible.

    Attributes:
      nv, ne:        (B,) int32 vertex / edge counts.
      degseq:        (B, Vmax) int32 non-increasing degree sequences,
                     zero padded (this *is* the sigma_1 padding of Lemma 5).
      vlabel_hist:   (B, n_vlabels) int32.
      elabel_hist:   (B, n_elabels) int32.
    """

    nv: np.ndarray
    ne: np.ndarray
    degseq: np.ndarray
    vlabel_hist: np.ndarray
    elabel_hist: np.ndarray

    @property
    def batch_size(self) -> int:
        return int(self.nv.shape[0])

    @property
    def vmax(self) -> int:
        return int(self.degseq.shape[1])

    @classmethod
    def from_db(cls, db: GraphDB, vmax: Optional[int] = None) -> "PaddedGraphBatch":
        return cls.from_graphs(db.graphs, db.n_vlabels, db.n_elabels, vmax)

    @classmethod
    def from_graphs(cls, graphs: Sequence[Graph], n_vlabels: int, n_elabels: int,
                    vmax: Optional[int] = None) -> "PaddedGraphBatch":
        B = len(graphs)
        if vmax is None:
            vmax = max((g.n for g in graphs), default=1)
        nv = np.zeros(B, np.int32)
        ne = np.zeros(B, np.int32)
        degseq = np.zeros((B, vmax), np.int32)
        vh = np.zeros((B, n_vlabels), np.int32)
        eh = np.zeros((B, n_elabels), np.int32)
        for i, g in enumerate(graphs):
            nv[i] = g.n
            ne[i] = g.m
            s = g.degree_sequence()
            degseq[i, : min(len(s), vmax)] = s[:vmax]
            vh[i] = g.vertex_label_hist(n_vlabels)
            eh[i] = g.edge_label_hist(n_elabels)
        return cls(nv, ne, degseq, vh, eh)
