"""Launch of the fused q-gram filter cascade kernel
(``csrc/qgram_filter.cu``, DESIGN.md §13).

``fused_batched_call`` takes a query block and returns the (Q, B) bounds
and mask; ``fused_filter_call`` takes one query and returns (B,) ones,
its C_D seeded from aux column 4.  Both take operands already padded by
``ops``.  Tensors on the CPU go to the plain versions
(``ref.fused_batched_bounds``, ``ref.fused_filter_bounds``); tensors on a
CUDA device launch the kernel or raise — there is no fallback from the
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import LIBRARY, check_operands
from repro_torch.kernels.qgram_filter import ref

N_SCALARS = 6
Q_ALIGN = 8      # the kernel's register chunk of queries
U_ALIGN = 4      # 16-byte F_D loads


def fused_batched_call(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq,
                       qsig, aux, cdt=None):
    """(bounds, mask), both (Q, B) int32; contract of
    ``ref.fused_batched_bounds`` with Q a multiple of 8 and U of 4."""
    if fd.device.type == "cpu":
        return ref.fused_batched_bounds(scalars, fd, qfd, vhist, qvh, ehist,
                                        qeh, degseq, qsig, aux, cdt)
    ops = dict(scalars=scalars, fd=fd, qfd=qfd, vhist=vhist, qvh=qvh,
               ehist=ehist, qeh=qeh, degseq=degseq, qsig=qsig, aux=aux,
               cdt=cdt)
    check_operands("qgram_filter", **ops)
    Q, B, U = scalars.shape[0], fd.shape[0], fd.shape[1]
    NV, NE, VM = vhist.shape[1], ehist.shape[1], degseq.shape[1]
    want = dict(scalars=(Q, N_SCALARS), fd=(B, U), qfd=(Q, U),
                vhist=(B, NV), qvh=(Q, NV), ehist=(B, NE), qeh=(Q, NE),
                degseq=(B, VM), qsig=(Q, VM), aux=(B, 4), cdt=(Q, B))
    for name, shape in want.items():
        t = ops[name]
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"qgram_filter: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if Q % Q_ALIGN or U % U_ALIGN or B == 0:
        raise ValueError(f"qgram_filter: (Q, B, U) = {(Q, B, U)} is not "
                         f"padded (Q % {Q_ALIGN}, U % {U_ALIGN}, B > 0)")
    if fd.data_ptr() % 16 or qfd.data_ptr() % 16:
        raise ValueError("qgram_filter: fd / qfd must be 16-byte aligned")
    bounds = torch.empty((Q, B), dtype=torch.int32, device=fd.device)
    mask = torch.empty((Q, B), dtype=torch.int32, device=fd.device)
    fn = LIBRARY.function("repro_qgram_filter", 13, 6)
    err = fn(scalars.data_ptr(), fd.data_ptr(), qfd.data_ptr(),
             vhist.data_ptr(), qvh.data_ptr(), ehist.data_ptr(),
             qeh.data_ptr(), degseq.data_ptr(), qsig.data_ptr(),
             aux.data_ptr(), None if cdt is None else cdt.data_ptr(),
             bounds.data_ptr(), mask.data_ptr(), Q, B, U, NV, NE, VM,
             torch.cuda.current_stream(fd.device).cuda_stream)
    if err:
        raise RuntimeError(f"qgram_filter launch failed: CUDA error {err}")
    fused_batched_call.launches += 1
    return bounds, mask


fused_batched_call.launches = 0     # kernel launches (CPU calls excluded)


def fused_filter_call(scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq,
                      qsig, aux):
    """(bounds, mask), both (B,) int32, for one query; contract of
    ``ref.fused_filter_bounds`` with U a multiple of 4."""
    if fd.device.type == "cpu":
        return ref.fused_filter_bounds(scalars, fd, qfd, vhist, qvh, ehist,
                                       qeh, degseq, qsig, aux)
    ops = dict(scalars=scalars, fd=fd, qfd=qfd, vhist=vhist, qvh=qvh,
               ehist=ehist, qeh=qeh, degseq=degseq, qsig=qsig, aux=aux)
    check_operands("qgram_filter_single", **ops)
    B, U = fd.shape
    NV, NE, VM = vhist.shape[1], ehist.shape[1], degseq.shape[1]
    want = dict(scalars=(N_SCALARS,), fd=(B, U), qfd=(U,), vhist=(B, NV),
                qvh=(NV,), ehist=(B, NE), qeh=(NE,), degseq=(B, VM),
                qsig=(VM,), aux=(B, 5))
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"qgram_filter_single: {name} has shape "
                             f"{tuple(ops[name].shape)}, expected {shape}")
    if U % U_ALIGN or B == 0:
        raise ValueError(f"qgram_filter_single: (B, U) = {(B, U)} is not "
                         f"padded (U % {U_ALIGN}, B > 0)")
    if fd.data_ptr() % 16 or qfd.data_ptr() % 16:
        raise ValueError("qgram_filter_single: fd / qfd must be 16-byte "
                         "aligned")
    bounds = torch.empty((B,), dtype=torch.int32, device=fd.device)
    mask = torch.empty((B,), dtype=torch.int32, device=fd.device)
    fn = LIBRARY.function("repro_qgram_filter_single", 12, 5)
    err = fn(scalars.data_ptr(), fd.data_ptr(), qfd.data_ptr(),
             vhist.data_ptr(), qvh.data_ptr(), ehist.data_ptr(),
             qeh.data_ptr(), degseq.data_ptr(), qsig.data_ptr(),
             aux.data_ptr(), bounds.data_ptr(), mask.data_ptr(), B, U, NV,
             NE, VM, torch.cuda.current_stream(fd.device).cuda_stream)
    if err:
        raise RuntimeError(f"qgram_filter_single launch failed: CUDA error "
                           f"{err}")
    fused_filter_call.launches += 1
    return bounds, mask


fused_filter_call.launches = 0      # kernel launches (CPU calls excluded)
