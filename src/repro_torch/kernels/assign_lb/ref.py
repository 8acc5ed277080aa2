"""Plain PyTorch version of the batched assignment lower bound — the
oracle the CUDA kernel is held against, and the body of the ``torch``
backend's stage 1.5 (DESIGN.md §16).

The bound (BRANCH family): every vertex carries a *branch* — its label
plus the multiset of incident edge labels.  With doubled integer costs

  C2(u, v) = 2·[l(u) != l(v)] + max(d(u), d(v)) - sum_e min(EH_u[e], EH_v[e])
  C2(u, ε) = 2 + d(u)          C2(ε, v) = 2 + d(v)

the Hausdorff relaxation of the optimal branch assignment gives

  LB2 = max( sum_u min_{v ∪ ε} C2(u, v),  sum_v min_{u ∪ ε} C2(u, v) )
  LB  = (LB2 + 1) // 2  <=  GED.

Pad vertices (label -1 / degree 0 / zero histograms) price exactly as
the ε column, so the min axes need no masking; only the two sums mask by
the true vertex counts ``qn`` / ``dn``.
"""
from __future__ import annotations

import torch


def batched_assign_lb(qv, qd, qeh, qn, dv, dd, deh, dn):
    """(Q, N) int32 Hausdorff branch lower bounds.

    qv/qd (Q, VMq), qeh (Q, VMq, NE), qn (Q,) true query vertex counts;
    dv/dd (N, VM), deh (N, VM, NE), dn (N,) the database side.
    """
    Q, VMq = qv.shape
    N, VM = dv.shape
    dn = dn.long()
    vmask = torch.arange(VM, device=dv.device)[None, :] < dn[:, None]
    colcap = 2 + dd.long()                                # (N, VM)
    rows = []
    # one query at a time keeps the (N, VMq, VM, NE) intermediate bounded
    for r in range(Q):
        lbl = 2 * (qv[r][None, :, None] != dv[:, None, :]).long()
        dmax = torch.maximum(qd[r][None, :, None], dd[:, None, :]).long()
        inter = torch.minimum(qeh[r][None, :, None, :],
                              deh[:, None, :, :]).sum(-1)
        c2 = lbl + dmax - inter                           # (N, VMq, VM)
        rowmin = torch.minimum(c2.min(dim=2).values,
                               2 + qd[r].long()[None, :])
        umask = torch.arange(VMq, device=qv.device) < qn[r].long()
        rowsum = (rowmin * umask[None, :]).sum(1)
        colmin = torch.minimum(c2.min(dim=1).values, colcap)
        colsum = (colmin * vmask).sum(1)
        lb2 = torch.maximum(rowsum, colsum)
        rows.append(torch.div(lb2 + 1, 2, rounding_mode="floor"))
    return torch.stack(rows).int()
