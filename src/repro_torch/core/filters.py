"""The paper's filters (Sections 2–3), host/numpy reference semantics.

Every function returns an *admissible lower bound* on ged(g, h) — a graph is
pruned iff its bound exceeds tau, so filtering never produces false
dismissals.  The device versions (``kernels/qgram_filter``) must agree
exactly with these (tested).

Filters implemented:
  * number count (Zeng et al.)                 -> ``number_count_lb``
  * label count  (Zhao et al.)                 -> ``label_count_lb``
  * label-based q-gram counting (Sec 3.2)      -> ``label_qgram_lb``
  * degree-based q-gram counting (Lemma 2)     -> ``degree_qgram_lb``
  * degree-sequence filter (Lemma 5)           -> ``degree_sequence_lb``

Lemma 5 case II note (|V_h| > |V_g|): the paper's lambda_e minimises over
all vertex-deleted subgraphs h_1, which is combinatorial.  We use the exact
closed-form *relaxation* derived in DESIGN.md: allowing arbitrary degree
reductions of the kept vertices (a superset of achievable h_1) and dropping
the ceilings gives

    lambda_e  >=  |E_h| + |E_g| - sum_i min(sigma_g[i], sigma_h[i]),

with both sequences sorted non-increasing and the sum over the first |V_g|
entries.  This is a valid lower bound of the paper's minimum (proof in
DESIGN.md; property-tested against brute-force GED).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.graphs.graph import Graph


# --------------------------------------------------------------------------
# scalar (two-graph) forms
# --------------------------------------------------------------------------

def number_count_lb(nv_g: int, ne_g: int, nv_h: int, ne_h: int) -> int:
    """dist_N(g,h) = ||Vg|-|Vh|| + ||Eg|-|Eh||  <=  ged(g,h)."""
    return abs(nv_g - nv_h) + abs(ne_g - ne_h)


def multiset_overlap(hist_a: np.ndarray, hist_b: np.ndarray) -> int:
    """|A ∩ B| for multisets given as histograms."""
    return int(np.minimum(hist_a, hist_b).sum())


def label_count_lb(nv_g: int, ne_g: int, nv_h: int, ne_h: int,
                   overlap_v: int, overlap_e: int) -> int:
    """dist_L(g,h) <= ged(g,h) (Section 2)."""
    return max(nv_g, nv_h) - overlap_v + max(ne_g, ne_h) - overlap_e


def label_qgram_lb(nv_g: int, ne_g: int, nv_h: int, ne_h: int, c_l: int) -> int:
    """Label-based q-gram counting filter (Sec 3.2, = label count rewritten).

    C_L = |L(g) ∩ L(h)|; bound: ged >= max(|Vg|,|Vh|) + max(|Eg|,|Eh|) - C_L.
    """
    return max(nv_g, nv_h) + max(ne_g, ne_h) - c_l


def degree_qgram_lb(nv_g: int, nv_h: int, overlap_v: int, c_d: int) -> int:
    """Degree-based q-gram counting filter (Lemma 2).

    From |D(g) ∩ D(h)| >= 2 max(|Vg|,|Vh|) - overlap_v - 2 tau:
        ged >= ceil((2 max(|Vg|,|Vh|) - overlap_v - C_D) / 2).
    """
    num = 2 * max(nv_g, nv_h) - overlap_v - c_d
    return max(0, -(-num // 2))  # ceil for positive, floor-free for negative


def degseq_delta(x: np.ndarray, y: np.ndarray) -> int:
    """Definition 6: Delta(x, y) with the two ceil-halved one-sided sums.

    x, y are equal-length degree vectors (align by zero-padding).
    """
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    if x.shape != y.shape:
        n = max(len(x), len(y))
        x = np.pad(x, (0, n - len(x)))
        y = np.pad(y, (0, n - len(y)))
    d = x - y
    s1 = int(np.maximum(d, 0).sum())    # entries where y < x
    s2 = int(np.maximum(-d, 0).sum())   # entries where y > x
    return -(-s1 // 2) + (-(-s2 // 2))


def degree_sequence_lb(nv_g: int, ne_g: int, sigma_g: np.ndarray,
                       nv_h: int, ne_h: int, sigma_h: np.ndarray,
                       overlap_v: int) -> int:
    """Degree-sequence filter (Lemma 5): ged >= max(|Vg|,|Vh|) - overlap_v + lambda_e."""
    sigma_g = np.sort(np.asarray(sigma_g, np.int64))[::-1]
    sigma_h = np.sort(np.asarray(sigma_h, np.int64))[::-1]
    if nv_h <= nv_g:
        # case I: sigma_1 = sigma_h zero-padded to |Vg| — exact.
        pad = np.pad(sigma_h, (0, nv_g - nv_h))
        lam = degseq_delta(sigma_g, pad)
    else:
        # case II: closed-form relaxation (see module docstring).
        top = sigma_h[:nv_g]
        lam = int(ne_h + ne_g - np.minimum(sigma_g, top).sum())
        lam = max(lam, 0)
    return max(nv_g, nv_h) - overlap_v + lam


# --------------------------------------------------------------------------
# convenience: all filters for a pair of graphs
# --------------------------------------------------------------------------

def pairwise_bounds(g: Graph, h: Graph, n_vlabels: int, n_elabels: int,
                    c_d: Optional[int] = None) -> Dict[str, int]:
    """All lower bounds for a (g, h) pair.  ``c_d`` (degree q-gram
    intersection size) may be supplied to avoid recomputation."""
    from repro_torch.core.qgrams import degree_qgrams  # local import to avoid cycle
    from collections import Counter

    vh_g = g.vertex_label_hist(n_vlabels)
    vh_h = h.vertex_label_hist(n_vlabels)
    eh_g = g.edge_label_hist(n_elabels)
    eh_h = h.edge_label_hist(n_elabels)
    overlap_v = multiset_overlap(vh_g, vh_h)
    overlap_e = multiset_overlap(eh_g, eh_h)
    c_l = overlap_v + overlap_e
    if c_d is None:
        cg = Counter(degree_qgrams(g))
        ch = Counter(degree_qgrams(h))
        c_d = sum(min(cg[k], ch[k]) for k in cg.keys() & ch.keys())
    bounds = {
        "number_count": number_count_lb(g.n, g.m, h.n, h.m),
        "label_count": label_count_lb(g.n, g.m, h.n, h.m, overlap_v, overlap_e),
        "label_qgram": label_qgram_lb(g.n, g.m, h.n, h.m, c_l),
        "degree_qgram": degree_qgram_lb(g.n, h.n, overlap_v, c_d),
        "degree_sequence": degree_sequence_lb(
            g.n, g.m, g.degree_sequence(), h.n, h.m, h.degree_sequence(),
            overlap_v),
    }
    bounds["combined"] = max(bounds.values())
    return bounds


# --------------------------------------------------------------------------
# batched numpy forms (oracle for the torch / CUDA paths)
# --------------------------------------------------------------------------

def batched_bounds_np(nv: np.ndarray, ne: np.ndarray, degseq: np.ndarray,
                      vhist: np.ndarray, ehist: np.ndarray,
                      c_d: np.ndarray,
                      q_nv: int, q_ne: int, q_degseq: np.ndarray,
                      q_vhist: np.ndarray, q_ehist: np.ndarray) -> Dict[str, np.ndarray]:
    """Vectorised filters: database batch (B, ...) against one query.

    ``degseq`` is (B, Vmax) non-increasing zero-padded; ``q_degseq`` is
    (Vmax,) likewise.  ``c_d`` is the per-graph degree-q-gram intersection
    size (computed by the q-gram kernel / CSR merge).
    """
    nv = nv.astype(np.int64)
    ne = ne.astype(np.int64)
    overlap_v = np.minimum(vhist, q_vhist[None, :]).sum(axis=1)
    overlap_e = np.minimum(ehist, q_ehist[None, :]).sum(axis=1)
    c_l = overlap_v + overlap_e
    max_nv = np.maximum(nv, q_nv)
    max_ne = np.maximum(ne, q_ne)

    number_count = np.abs(nv - q_nv) + np.abs(ne - q_ne)
    label_count = max_nv - overlap_v + max_ne - overlap_e
    label_qgram = max_nv + max_ne - c_l
    degree_qgram = np.maximum(0, -(-(2 * max_nv - overlap_v - c_d) // 2))

    # degree-sequence filter, both cases vectorised (zero-padding aligns):
    dq = degseq.astype(np.int64)
    qq = q_degseq.astype(np.int64)[None, :]
    d = dq - qq
    s1 = np.maximum(d, 0).sum(axis=1)   # query below data
    s2 = np.maximum(-d, 0).sum(axis=1)
    # case I (q_nv <= nv): Delta with zero-padded query — but only rows where
    # q_nv <= nv may use it; other rows use the case II closed form.
    delta = -(-s1 // 2) + (-(-s2 // 2))
    min_sum = np.minimum(dq, qq).sum(axis=1)
    lam_2 = np.maximum(q_ne + ne - min_sum, 0)
    lam = np.where(q_nv <= nv, delta, lam_2)
    degree_sequence = max_nv - overlap_v + lam

    out = {
        "number_count": number_count,
        "label_count": label_count,
        "label_qgram": label_qgram,
        "degree_qgram": degree_qgram,
        "degree_sequence": degree_sequence,
    }
    out["combined"] = np.maximum.reduce(list(out.values()))
    return out
