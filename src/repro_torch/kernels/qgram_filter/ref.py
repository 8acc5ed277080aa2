"""Plain PyTorch version of the fused filter cascade — the oracle the CUDA
kernel is held against, and the body of the ``torch`` backend.

Same (Q, B) contract as ``kernel.fused_batched_call``, and the (B,)
single-query contract of ``kernel.fused_filter_call``; runs on any
device.  Every ``//`` of the cascade is a floor division
(``rounding_mode="floor"``): the region numerators go negative.
"""
from __future__ import annotations

import torch


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def fused_batched_bounds(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq,
                         qsig, aux, cdt=None):
    """(bounds, mask), both (Q, B) int32.

    scalars (Q, 6): q_nv, q_ne, tau, x0, y0, l; fd (B, U); qfd (Q, U);
    vhist (B, NV); qvh (Q, NV); ehist (B, NE); qeh (Q, NE); degseq
    (B, VM); qsig (Q, VM); aux (B, >=4): nv, ne, region_i, region_j;
    cdt (Q, B) C_D seed or None for zeros.
    """
    sc = scalars.long()
    q_nv, q_ne, tau, x0, y0, l = (sc[:, i:i + 1] for i in range(6))
    nv, ne, ri, rj = (aux[:, i].long()[None, :] for i in range(4))
    # one query row at a time keeps the (B, U) intermediate bounded
    c_d = torch.stack([torch.minimum(fd, qfd[r][None, :]).sum(1)
                       for r in range(sc.shape[0])])
    if cdt is not None:
        c_d = c_d + cdt.long()
    overlap_v = torch.minimum(vhist[None], qvh[:, None]).sum(-1)
    overlap_e = torch.minimum(ehist[None], qeh[:, None]).sum(-1)
    max_nv = torch.maximum(nv, q_nv)
    max_ne = torch.maximum(ne, q_ne)

    number_count = (nv - q_nv).abs() + (ne - q_ne).abs()
    label_qgram = max_nv + max_ne - (overlap_v + overlap_e)
    degree_qgram = _fdiv(2 * max_nv - overlap_v - c_d + 1, 2).clamp(min=0)

    d = degseq[None].long() - qsig[:, None].long()
    s1 = d.clamp(min=0).sum(-1)
    s2 = (-d).clamp(min=0).sum(-1)
    delta = _fdiv(s1 + 1, 2) + _fdiv(s2 + 1, 2)
    min_deg = torch.minimum(degseq[None], qsig[:, None]).sum(-1)
    lam2 = (q_ne + ne - min_deg).clamp(min=0)
    lam = torch.where(q_nv <= nv, delta, lam2)
    degree_sequence = max_nv - overlap_v + lam

    bound = torch.maximum(torch.maximum(number_count, label_qgram),
                          torch.maximum(degree_qgram, degree_sequence))

    s, dd = x0 + y0, y0 - x0
    i1 = _fdiv(q_ne - tau + q_nv - s, l)
    i2 = _fdiv(q_ne + tau + q_nv - s, l)
    j1 = _fdiv(q_ne - tau - q_nv - dd, l)
    j2 = _fdiv(q_ne + tau - q_nv - dd, l)
    in_region = (ri >= i1) & (ri <= i2) & (rj >= j1) & (rj <= j2)
    return bound.int(), (in_region & (bound <= tau)).int()


def fused_filter_bounds(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq,
                        qsig, aux):
    """(bounds, mask), both (B,) int32, for one query: scalars (6,), qfd
    (U,), qvh (NV,), qeh (NE,), qsig (VM,), aux (B, 5) whose column 4
    seeds C_D (the hot prefix's cold-vocabulary tail)."""
    b, m = fused_batched_bounds(scalars[None], fd, qfd[None], vhist,
                                qvh[None], ehist, qeh[None], degseq,
                                qsig[None], aux, aux[:, 4][None])
    return b[0], m[0]
