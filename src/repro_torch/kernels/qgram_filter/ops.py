"""Padding and launch wrapper for the fused filter kernel.

Padded shapes round up to the shared shape-bucket ladder
(``shape_bucket``: powers of two times a base up to a cap, then cap
multiples), the same ladders as the JAX package's kernel wrapper, so the
engine gathers and caches a bounded set of bucket shapes (DESIGN.md §13).
Q pads by repeating the last scalar row (always-valid geometry; padded
rows are sliced off), B with impossible graphs (aux = -2**20), U with
zero counts (a no-op for the min-sum).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Q_BASE, Q_CAP = 8, 64
B_BASE, B_CAP = 8, 512
U_BASE, U_CAP = 128, 512
IMPOSSIBLE = -(2 ** 20)


def _next_mult(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shape_bucket(n: int, base: int, cap: int) -> int:
    """Round ``n`` up to the shared shape-bucket ladder: powers of two
    times ``base`` up to ``cap``, then multiples of ``cap``."""
    m = base
    while m < n and m < cap:
        m *= 2
    return m if n <= m else _next_mult(n, cap)


def make_scalars_batch(qs, x0: int, y0: int, l: int) -> np.ndarray:
    """(Q, 6) scalar rows for a stacked query block."""
    return np.asarray([[int(q.nv), int(q.ne), int(q.tau), x0, y0, l]
                       for q in qs], np.int32)


def pad_to(x: torch.Tensor, n: int, axis: int, value: int = 0
           ) -> torch.Tensor:
    """Pad ``axis`` of ``x`` up to ``n`` with ``value`` (no copy when it
    already has that size)."""
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths, value=value)


def pad_batched(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq, qsig,
                aux, cdt=None) -> Tuple[torch.Tensor, ...]:
    """Every operand padded to the ladders; ``cdt=None`` stays None (the
    kernel and the plain version read it as zeros)."""
    Q, (B, U) = scalars.shape[0], fd.shape
    qp = shape_bucket(Q, Q_BASE, Q_CAP)
    bp = shape_bucket(B, B_BASE, B_CAP)
    up = shape_bucket(U, U_BASE, U_CAP)
    if qp > Q:
        scalars = torch.cat([scalars, scalars[-1:].expand(qp - Q, -1)])
    return (scalars.contiguous(),
            pad_to(pad_to(fd, bp, 0), up, 1),
            pad_to(pad_to(qfd, qp, 0), up, 1),
            pad_to(vhist, bp, 0), pad_to(qvh, qp, 0),
            pad_to(ehist, bp, 0), pad_to(qeh, qp, 0),
            pad_to(degseq, bp, 0), pad_to(qsig, qp, 0),
            pad_to(aux[:, :4].contiguous(), bp, 0, value=IMPOSSIBLE),
            None if cdt is None else pad_to(pad_to(cdt, qp, 0), bp, 1))


def pad_single(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq, qsig,
               aux) -> Tuple[torch.Tensor, ...]:
    """One query's operands padded to the ladders: B with impossible
    graphs (every aux column at -2**20, so the bound is huge and the
    region test fails), U with zero counts; the query side only in U."""
    B, U = fd.shape
    bp = shape_bucket(B, B_BASE, B_CAP)
    up = shape_bucket(U, U_BASE, U_CAP)
    return (scalars.contiguous(), pad_to(pad_to(fd, bp, 0), up, 1),
            pad_to(qfd, up, 0), pad_to(vhist, bp, 0), qvh,
            pad_to(ehist, bp, 0), qeh, pad_to(degseq, bp, 0), qsig,
            pad_to(aux, bp, 0, value=IMPOSSIBLE))


def fused_filter_bounds(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq,
                        qsig, aux, *, fn: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bounds, mask), both (B,), for a database shard vs one query.

    ``aux`` is (B, 5): nv, ne, region_i, region_j and the C_D seed (the
    hot prefix's cold-vocabulary tail; zeros for the full vocabulary).
    ``fn`` is what runs on the operands padded by ``pad_single``: the
    kernel wrapper ``kernel.fused_filter_call`` by default,
    ``ref.fused_filter_bounds`` for the plain version.
    """
    if fn is None:
        from repro_torch.kernels.qgram_filter.kernel import fused_filter_call
        fn = fused_filter_call
    bounds, mask = fn(*pad_single(scalars, fd, qfd, vhist, qvh, ehist, qeh,
                                  degseq, qsig, aux))
    B = fd.shape[0]
    return bounds[:B], mask[:B]


def fused_filter_bounds_batched(scalars, fd, qfd, vhist, qvh, ehist, qeh,
                                degseq, qsig, aux, cdt=None, *,
                                fn: Optional[Callable] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bounds, mask), both (Q, B), for a database shard vs a whole query
    block — one kernel launch for every (query, graph) pair.

    ``fn`` is what runs on the padded operands: the kernel wrapper
    ``kernel.fused_batched_call`` by default, ``ref.fused_batched_bounds``
    for the plain version.
    """
    if fn is None:
        from repro_torch.kernels.qgram_filter.kernel import fused_batched_call
        fn = fused_batched_call
    Q, B = scalars.shape[0], fd.shape[0]
    bounds, mask = fn(*pad_batched(scalars, fd, qfd, vhist, qvh, ehist, qeh,
                                   degseq, qsig, aux, cdt))
    return bounds[:Q, :B], mask[:Q, :B]


def upload_fd(fd: np.ndarray, device: torch.device) -> torch.Tensor:
    """A gathered (B, U) F_D slab on ``device``, its columns zero-padded
    to the U ladder (so ``pad_batched`` leaves it as it is)."""
    B, U = fd.shape
    up = shape_bucket(U, U_BASE, U_CAP)
    host = torch.from_numpy(np.ascontiguousarray(fd, np.int32))
    if up == U:
        return host.to(device)
    out = torch.zeros((B, up), dtype=torch.int32, device=device)
    out[:, :U].copy_(host)
    return out
