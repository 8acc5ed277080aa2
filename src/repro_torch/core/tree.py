"""Query-side four-tuple of Algorithm 1 (the q-gram tree itself is not
part of this package yet)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.qgrams import QGramVocab


@dataclass
class QueryTuple:
    """LD' of Algorithm 1 plus the degree sequence sigma_h."""

    nv: int
    ne: int
    d_ids: np.ndarray
    d_cnt: np.ndarray
    l_ids: np.ndarray
    l_cnt: np.ndarray
    sigma: np.ndarray

    @classmethod
    def from_graph(cls, h, vocab: QGramVocab) -> "QueryTuple":
        dc = vocab.encode_degree(h)
        known = sorted(k for k in dc if k >= 0)
        lc = vocab.encode_label(h)
        lids = sorted(lc)
        return cls(
            nv=h.n,
            ne=h.m,
            d_ids=np.array(known, np.int64),
            d_cnt=np.array([dc[k] for k in known], np.int64),
            l_ids=np.array(lids, np.int64),
            l_cnt=np.array([lc[k] for k in lids], np.int64),
            sigma=h.degree_sequence().astype(np.int64),
        )
