"""Host-side paths and padding for the assignment lower bound
(DESIGN.md §16): the vectorised numpy oracle, the optional tighter
Hungarian relaxation, and the query-block padding the kernel takes.

All three backends (numpy / torch / cuda) compute the same integers —
the bound is provable, so candidate *verification decisions* derived
from it are bit-identical everywhere.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.kernels.qgram_filter.ops import shape_bucket

# shape-bucket ladders for the (Q, N) LB pass — queries are tiny, the
# candidate-union axis tracks the filter's B ladder
Q_BASE, Q_CAP = 8, 64
N_BASE, N_CAP = 8, 512
VM_BASE, VM_CAP = 8, 128


def _pairwise_c2(qv: np.ndarray, qd: np.ndarray, qeh: np.ndarray,
                 dv: np.ndarray, dd: np.ndarray, deh: np.ndarray
                 ) -> np.ndarray:
    """(..., VMq, VM) doubled branch-edit costs for one query block row
    against one database block (numpy, broadcast over leading axes)."""
    lbl = 2 * (qv[..., :, None] != dv[..., None, :]).astype(np.int64)
    dmax = np.maximum(qd[..., :, None], dd[..., None, :])
    inter = np.minimum(qeh[..., :, None, :],
                       deh[..., None, :, :]).sum(axis=-1)
    return lbl + dmax - inter


def assign_lb_np(qv, qd, qeh, qn, dv, dd, deh, dn) -> np.ndarray:
    """(Q, N) int32 Hausdorff branch lower bounds — numpy oracle with the
    exact contract of ``ref.batched_assign_lb``."""
    qv, qd, qeh = (np.asarray(x) for x in (qv, qd, qeh))
    dv, dd, deh = (np.asarray(x) for x in (dv, dd, deh))
    qn = np.asarray(qn, np.int64)
    dn = np.asarray(dn, np.int64)
    Q, VMq = qv.shape
    N, VM = dv.shape
    out = np.empty((Q, N), np.int32)
    vmask = np.arange(VM)[None, :] < dn[:, None]          # (N, VM)
    for r in range(Q):
        # query row (1, VMq, ...) broadcast against the db block (N, VM, ...)
        c2 = _pairwise_c2(qv[r][None, :], qd[r][None, :], qeh[r][None, :, :],
                          dv, dd, deh)                    # (N, VMq, VM)
        rowmin = np.minimum(c2.min(axis=2), (2 + qd[r])[None, :])
        rowsum = rowmin[:, :int(qn[r])].sum(axis=1)       # (N,)
        colmin = np.minimum(c2.min(axis=1), 2 + dd)       # (N, VM)
        colsum = np.where(vmask, colmin, 0).sum(axis=1)
        out[r] = (np.maximum(rowsum, colsum) + 1) // 2
    return out


def hungarian_lb_pair(qv, qd, qeh, dv, dd, deh) -> Optional[int]:
    """Exact assignment LB for one (query, graph) pair of *unpadded*
    branch features: ``ceil(min-cost-assignment(C2) / 2)``.  Tighter than
    (never below) the Hausdorff relaxation, still ``<= GED``.  Returns
    None when scipy is unavailable — callers keep the Hausdorff value.
    """
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:                                   # pragma: no cover
        return None
    n1, n2 = len(qd), len(dd)
    if n1 == 0 and n2 == 0:
        return 0
    big = np.int64(1) << 30
    c = np.full((n1 + n2, n1 + n2), big, np.int64)
    if n1 and n2:
        c[:n1, :n2] = _pairwise_c2(qv, qd, qeh, dv, dd, deh)
    c[np.arange(n1), n2 + np.arange(n1)] = 2 + np.asarray(qd, np.int64)
    c[n1 + np.arange(n2), np.arange(n2)] = 2 + np.asarray(dd, np.int64)
    c[n1:, n2:] = 0
    r, col = linear_sum_assignment(c)
    return int((int(c[r, col].sum()) + 1) // 2)


def _pad_rows(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, w, constant_values=fill)


def _pad_cols(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = n - x.shape[1]
    if pad <= 0:
        return x
    w = [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, w, constant_values=fill)


def pad_query_block(qv, qd, qeh, qn, vmq: Optional[int] = None
                    ) -> Tuple[np.ndarray, ...]:
    """Pad a stacked query block to the (Q, VMq) shape buckets: Q rides
    the power-of-2 ladder (pad rows have no vertices and are sliced off),
    VMq likewise (pad vertices price as ε).  Keeping both on ladders
    bounds the set of shapes the device cache and the kernel see."""
    Q = qv.shape[0]
    qp = shape_bucket(max(Q, 1), Q_BASE, Q_CAP)
    vm = shape_bucket(max(qv.shape[1], 1) if vmq is None else int(vmq),
                      VM_BASE, VM_CAP)
    qv = _pad_cols(_pad_rows(np.asarray(qv, np.int32), qp, -1), vm, -1)
    qd = _pad_cols(_pad_rows(np.asarray(qd, np.int32), qp), vm)
    qeh = _pad_cols(_pad_rows(np.asarray(qeh, np.int32), qp), vm)
    qn = _pad_rows(np.asarray(qn, np.int32), qp)
    return qv, qd, qeh, qn
