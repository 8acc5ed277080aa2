"""Array containers + host-side builders for the vectorised filter paths.

The containers are layout-only NamedTuples: numpy arrays on the host,
torch tensors once a backend moves them to its device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np


class DBArrays(NamedTuple):
    """Database shard (all (B, ...) along the graph axis)."""

    nv: Any             # (B,)   int32
    ne: Any             # (B,)   int32
    degseq: Any         # (B, Vmax) int32, non-increasing, zero-padded
    vhist: Any          # (B, n_vlabels) int32
    ehist: Any          # (B, n_elabels) int32
    fd: Any             # (B, U) int32 dense degree-q-gram frequencies
    region_i: Any       # (B,)   int32
    region_j: Any       # (B,)   int32


class QueryArrays(NamedTuple):
    nv: Any             # () int32
    ne: Any             # () int32
    sigma: Any          # (Vmax,) int32
    vhist: Any          # (n_vlabels,) int32
    ehist: Any          # (n_elabels,) int32
    fd: Any             # (U,) int32
    tau: Any            # () int32


def query_arrays_from_graph(h, vocab, partition, tau: int, vmax: int,
                            hot: Optional[int] = None,
                            qt=None) -> QueryArrays:
    """Query-side arrays; pass a precomputed ``QueryTuple`` as ``qt`` to
    skip re-encoding (the engine's LRU cache does)."""
    from repro_torch.core.tree import QueryTuple

    q = QueryTuple.from_graph(h, vocab) if qt is None else qt
    U = vocab.n_degree_ids if hot is None else min(hot, vocab.n_degree_ids)
    fd = np.zeros(max(U, 1), np.int32)
    sel = q.d_ids < U
    fd[q.d_ids[sel]] = q.d_cnt[sel]
    sigma = np.zeros(vmax, np.int32)
    sigma[:min(len(q.sigma), vmax)] = q.sigma[:vmax]
    return QueryArrays(
        nv=np.int32(h.n), ne=np.int32(h.m), sigma=sigma,
        vhist=h.vertex_label_hist(vocab.n_vlabels).astype(np.int32),
        ehist=h.edge_label_hist(vocab.n_elabels).astype(np.int32),
        fd=fd, tau=np.int32(tau))
