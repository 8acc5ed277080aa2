"""Launch of the batched assignment lower bound kernel
(``csrc/assign_lb.cu``, DESIGN.md §16).

Tensors on the CPU go to the plain version
(``ref.batched_assign_lb``); tensors on a CUDA device launch the kernel
or raise — there is no fallback from the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import LIBRARY, check_operands
from repro_torch.kernels.assign_lb import ref

VM_MAX = 256     # db vertices a warp holds in registers (32 lanes x 8)


def assign_lb_call(qv, qd, qeh, qn, dv, dd, deh, dn):
    """(Q, N) int32 LBs; the contract of ``ref.batched_assign_lb``."""
    if dv.device.type == "cpu":
        return ref.batched_assign_lb(qv, qd, qeh, qn, dv, dd, deh, dn)
    ops = dict(qv=qv, qd=qd, qeh=qeh, qn=qn, dv=dv, dd=dd, deh=deh, dn=dn)
    check_operands("assign_lb", **ops)
    (Q, VMq), (N, VM), NE = qv.shape, dv.shape, deh.shape[2]
    want = dict(qv=(Q, VMq), qd=(Q, VMq), qeh=(Q, VMq, NE), qn=(Q,),
                dv=(N, VM), dd=(N, VM), deh=(N, VM, NE), dn=(N,))
    for name, shape in want.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"assign_lb: {name} has shape "
                             f"{tuple(ops[name].shape)}, expected {shape}")
    if VM > VM_MAX or Q * N == 0:
        raise ValueError(f"assign_lb: needs 0 < Q*N and VM <= {VM_MAX}, "
                         f"got Q={Q} N={N} VM={VM}")
    out = torch.empty((Q, N), dtype=torch.int32, device=dv.device)
    fn = LIBRARY.function("repro_assign_lb", 9, 5)
    err = fn(qv.data_ptr(), qd.data_ptr(), qeh.data_ptr(), qn.data_ptr(),
             dv.data_ptr(), dd.data_ptr(), deh.data_ptr(), dn.data_ptr(),
             out.data_ptr(), Q, N, VMq, VM, NE,
             torch.cuda.current_stream(dv.device).cuda_stream)
    if err:
        raise RuntimeError(f"assign_lb launch failed: CUDA error {err}")
    assign_lb_call.launches += 1
    return out


assign_lb_call.launches = 0     # kernel launches (CPU calls excluded)
