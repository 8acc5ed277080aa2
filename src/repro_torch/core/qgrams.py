"""Q-gram extraction (Definitions 4 and 5) and frequency encodings.

Degree-based q-gram of vertex v:  D_v = (mu(v), multiset of adjacent edge
labels, d_v).  Label-based q-gram set: L(g) = Sigma_Vg  ∪  Sigma_Eg (as a
multiset; vertex labels and edge labels live in disjoint id ranges).

The global vocabularies U_D / U_L are frequency-ordered (most frequent
q-gram gets id 0) exactly as in Section 5.1 — this makes the per-graph
frequency arrays F_D / F_L dense at the front and zero-heavy at the tail,
which the ``hot``-prefix slab layout exploits.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphs.graph import Graph, GraphDB

DegreeQGram = Tuple[int, Tuple[int, ...], int]  # (vlabel, sorted adj elabels, degree)


def degree_qgrams(g: Graph) -> List[DegreeQGram]:
    """D(g): one degree-based q-gram per vertex."""
    adj: List[List[int]] = [[] for _ in range(g.n)]
    for (u, v), l in zip(g.edges, g.elabels):
        adj[int(u)].append(int(l))
        adj[int(v)].append(int(l))
    out: List[DegreeQGram] = []
    for v in range(g.n):
        labels = tuple(sorted(adj[v]))
        out.append((int(g.vlabels[v]), labels, len(labels)))
    return out


def label_qgrams(g: Graph, n_vlabels: int) -> List[int]:
    """L(g) as integer ids: vertex label l -> l; edge label l -> n_vlabels+l."""
    ids = [int(l) for l in g.vlabels]
    ids += [n_vlabels + int(l) for l in g.elabels]
    return ids


@dataclass
class QGramVocab:
    """Frequency-ordered vocabulary of degree-based and label-based q-grams."""

    degree_ids: Dict[DegreeQGram, int]
    n_label_ids: int  # |U_L| = n_vlabels + n_elabels (dense, already ids)
    n_vlabels: int
    n_elabels: int
    degree_order: List[DegreeQGram] = field(default_factory=list)

    @property
    def n_degree_ids(self) -> int:
        return len(self.degree_ids)

    @classmethod
    def build(cls, db: GraphDB) -> "QGramVocab":
        counts: Counter = Counter()
        for g in db:
            counts.update(degree_qgrams(g))
        # most frequent first; ties broken deterministically by key repr
        order = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        degree_ids = {k: i for i, (k, _) in enumerate(order)}
        return cls(
            degree_ids=degree_ids,
            n_label_ids=db.n_vlabels + db.n_elabels,
            n_vlabels=db.n_vlabels,
            n_elabels=db.n_elabels,
            degree_order=[k for k, _ in order],
        )

    # ---- per-graph encodings --------------------------------------------
    def encode_degree(self, g: Graph, allow_unknown: bool = True) -> Counter:
        """Sparse F_D as {degree-qgram-id: count}; unknown grams get id -1."""
        c: Counter = Counter()
        for q in degree_qgrams(g):
            idx = self.degree_ids.get(q, -1)
            if idx < 0 and not allow_unknown:
                raise KeyError(f"unknown degree q-gram {q}")
            c[idx] += 1
        return c

    def encode_label(self, g: Graph) -> Counter:
        c: Counter = Counter()
        for i in label_qgrams(g, self.n_vlabels):
            c[i] += 1
        return c

    def degree_of_id(self, idx: int) -> int:
        """d_v of the degree-based q-gram with this id (the T_D table of Alg 1)."""
        return self.degree_order[idx][2]

    def degree_id_table(self) -> np.ndarray:
        """T_D as an array: id -> degree."""
        return np.array([q[2] for q in self.degree_order], np.int32)


@dataclass
class EncodedDB:
    """Whole-database sparse F_D/F_L in CSR form + dense hot-prefix matrices.

    CSR arrays (host/archival):
      d_ids / d_cnt with row offsets d_off — per-graph nonzero F_D entries,
      ids ascending.  Same for l_*.

    Dense "hot" matrices (accelerator serving format, DESIGN.md §3): the
    first ``hot_d`` / ``hot_l`` vocabulary columns as (B, hot) int matrices;
    the sparse *tail* beyond the hot prefix stays CSR and is corrected on
    host.  For typical skewed vocabularies the tail is a few % of mass.
    """

    vocab: QGramVocab
    d_off: np.ndarray
    d_ids: np.ndarray
    d_cnt: np.ndarray
    l_off: np.ndarray
    l_ids: np.ndarray
    l_cnt: np.ndarray
    nv: np.ndarray
    ne: np.ndarray

    @classmethod
    def build(cls, db: GraphDB, vocab: Optional[QGramVocab] = None) -> "EncodedDB":
        if vocab is None:
            vocab = QGramVocab.build(db)
        d_off = [0]
        l_off = [0]
        d_ids: List[int] = []
        d_cnt: List[int] = []
        l_ids: List[int] = []
        l_cnt: List[int] = []
        for g in db:
            dc = vocab.encode_degree(g)
            for i in sorted(k for k in dc if k >= 0):
                d_ids.append(i)
                d_cnt.append(dc[i])
            d_off.append(len(d_ids))
            lc = vocab.encode_label(g)
            for i in sorted(lc):
                l_ids.append(i)
                l_cnt.append(lc[i])
            l_off.append(len(l_ids))
        nv, ne = db.sizes()
        return cls(
            vocab=vocab,
            d_off=np.asarray(d_off, np.int64),
            d_ids=np.asarray(d_ids, np.int32),
            d_cnt=np.asarray(d_cnt, np.int32),
            l_off=np.asarray(l_off, np.int64),
            l_ids=np.asarray(l_ids, np.int32),
            l_cnt=np.asarray(l_cnt, np.int32),
            nv=nv,
            ne=ne,
        )

    def __len__(self) -> int:
        return len(self.d_off) - 1

    def row_degree(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return (self.d_ids[self.d_off[i]:self.d_off[i + 1]],
                self.d_cnt[self.d_off[i]:self.d_off[i + 1]])

    def row_label(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return (self.l_ids[self.l_off[i]:self.l_off[i + 1]],
                self.l_cnt[self.l_off[i]:self.l_off[i + 1]])

    # ---- dense hot-prefix serving layout ---------------------------------
    def dense_hot(self, hot_d: int, hot_l: Optional[int] = None,
                  dtype=np.int32) -> Tuple[np.ndarray, np.ndarray]:
        """(B, hot_d) F_D prefix and (B, hot_l) F_L prefix dense matrices."""
        if hot_l is None:
            hot_l = self.vocab.n_label_ids
        B = len(self)
        FD = np.zeros((B, hot_d), dtype)
        FL = np.zeros((B, hot_l), dtype)
        for i in range(B):
            ids, cnt = self.row_degree(i)
            sel = ids < hot_d
            FD[i, ids[sel]] = cnt[sel]
            ids, cnt = self.row_label(i)
            sel = ids < hot_l
            FL[i, ids[sel]] = cnt[sel]
        return FD, FL

    def tail_intersection(self, i: int, q_sparse: Dict[int, int], hot_d: int) -> int:
        """Sum over ids >= hot_d of min(F_D[i, id], q[id]) (host correction,
        one row; the serving path uses ``tail_intersection_bulk``)."""
        ids, cnt = self.row_degree(i)
        m = ids >= hot_d
        if not m.any():
            return 0
        qv = np.array([q_sparse.get(int(x), 0) for x in ids[m]], np.int64)
        return int(np.minimum(cnt[m].astype(np.int64), qv).sum())

    def tail_intersection_bulk(self, q_ids: np.ndarray, q_cnt: np.ndarray,
                               hot_d: int) -> np.ndarray:
        """Batched CSR tail min-sum: for every graph, sum over ids >= hot_d
        of min(F_D[g, id], q[id]) — the per-batch correction the ``hot``
        FilterSlab layout adds to the device hot-prefix C_D (DESIGN.md §11).

        One vectorised sweep over the whole CSR (no per-graph Python
        loop).  Bucket-restricted corrections go through the gathered
        ``FilterSlab`` tail instead — this always costs O(whole CSR).
        """
        q_ids = np.asarray(q_ids, np.int64)
        q_cnt = np.asarray(q_cnt, np.int64)
        return csr_tail_minsum(self.d_off, self.d_ids, self.d_cnt,
                               q_ids, q_cnt, hot_d,
                               self.vocab.n_degree_ids)


def csr_tail_minsum(off: np.ndarray, ids: np.ndarray, cnt: np.ndarray,
                    q_ids: np.ndarray, q_cnt: np.ndarray, hot_d: int,
                    n_ids: int) -> np.ndarray:
    """Vectorised per-row SUM over ids >= hot_d of min(cnt, q[id]).

    ``off``/``ids``/``cnt`` are any CSR multiset slab (rows need not be
    pre-split at hot_d); the query arrives sparse.  Counts are small, so
    the bincount accumulation (float64) is exact.
    """
    B = len(off) - 1
    out = np.zeros(B, np.int64)
    tail_w = n_ids - hot_d
    if tail_w > 0 and len(ids) and len(q_ids):
        q_tail = np.zeros(tail_w, np.int64)
        sel = (q_ids >= hot_d) & (q_ids < n_ids)
        q_tail[q_ids[sel] - hot_d] = q_cnt[sel]
        row_of = np.repeat(np.arange(B), np.diff(off))
        m = ids >= hot_d
        contrib = np.minimum(cnt[m].astype(np.int64), q_tail[ids[m] - hot_d])
        out = np.bincount(row_of[m], weights=contrib,
                          minlength=B).astype(np.int64)
    return out


def sparse_intersection_size(a_ids: np.ndarray, a_cnt: np.ndarray,
                             b_ids: np.ndarray, b_cnt: np.ndarray) -> int:
    """|A ∩ B| for multisets in sorted-CSR form: sum of min counts."""
    i = j = 0
    total = 0
    na, nb = len(a_ids), len(b_ids)
    while i < na and j < nb:
        if a_ids[i] == b_ids[j]:
            total += min(int(a_cnt[i]), int(b_cnt[j]))
            i += 1
            j += 1
        elif a_ids[i] < b_ids[j]:
            i += 1
        else:
            j += 1
    return total
