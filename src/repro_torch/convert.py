"""Carry a database across from the JAX package's state.

The port shares no code with the JAX package, so state crosses as plain
numpy arrays (or as the ``GraphDB.save`` npz file, which
``repro_torch.graphs.GraphDB.load`` reads unchanged).  Everything derived
from the database — q-gram vocabulary, encoding, region partition,
filter slab — is rebuilt deterministically from it, so the same database
gives the same index in both packages.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.graphs.graph import Graph, GraphDB


def graphdb_from_arrays(n: Sequence[int], vlabels: Sequence[np.ndarray],
                        edges: Sequence[np.ndarray],
                        elabels: Sequence[np.ndarray], n_vlabels: int,
                        n_elabels: int) -> GraphDB:
    """A ``GraphDB`` from per-graph arrays: ``n[i]`` vertices with labels
    ``vlabels[i]`` (n_i,), edges ``edges[i]`` (m_i, 2) labelled
    ``elabels[i]`` (m_i,), over ``n_vlabels`` / ``n_elabels`` labels."""
    if not (len(n) == len(vlabels) == len(edges) == len(elabels)):
        raise ValueError("n, vlabels, edges and elabels differ in length")
    graphs = [Graph(int(k), np.asarray(vl), np.asarray(e).reshape(-1, 2),
                    np.asarray(el))
              for k, vl, e, el in zip(n, vlabels, edges, elabels)]
    return GraphDB(graphs, int(n_vlabels), int(n_elabels))
