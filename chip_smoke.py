#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase (needs one card)
    python3 chip_smoke.py --phase kernels  # build + kernels vs plain only
    python3 chip_smoke.py --verbose-build  # also print ptxas -v output

Phases, each of which asserts and ends the run non-zero on failure:

1. **build**: compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process
   per source, all started together) into ``build/kernels/``, timed.
2. **kernels**: each CUDA kernel against its plain PyTorch version on the
   same CUDA tensors, at the shapes the msq_aids paths give it: the
   batched filter at a 3-query bucket padded to Q=8, B=10,240 graphs,
   U=1851 padded to 2048; the LB at Q=8, N=64, VMq=64, VM=56; the
   bit-unpack decode of a 10,240-row bucket (KB=15 blocks, W=128 words a
   row, msq_aids's widths) into its (10,240, 2048) F_D block, and again
   with rows at every width up to 32, in the row and the flat form; the
   single-query filter at B=10,240, U=2048 with a C_D seed in aux
   column 4; the rank popcount over 1,310,720 words (5,120 blocks).
   Every value is an int32, so the tolerance is zero.  Timed with CUDA
   events (and the profiler's device time where it reports one).
3. **slice**: the full msq_aids configuration (42,687 AIDS-like graphs,
   ``FlatMSQIndex``, assignment LB on), one batch of 64 range queries at
   tau=3 (2-edit perturbations of database graphs, rng seed 7) through
   ``GraphQueryEngine``.  The dense slab on the ``cuda`` backend, with
   the kernel launch counters reset just before and read just after;
   then the same batch on the ``torch`` backend (plain versions on the
   card) and the ``numpy`` backend (host oracle).  Then the packed slab
   on ``cuda`` (counters reset and read around it: one bit-unpack and
   one filter launch per non-empty bucket), and its candidate pass on
   ``torch`` and ``numpy``.  Candidates, filter bounds, LBs and matches
   must be identical across backends and slabs.
4. **entry points**: the single-query filter (``fused_filter_bounds``,
   one query over the whole slab, against the host oracle) and the rank
   dictionary (``build_rank_dictionary`` + ``rank1_query`` over a
   41,996,333-bit bitmap, against a numpy prefix count), each with its
   counter reset and read around it.

Then the card's name and power limit (``nvidia-smi``), one JSON line with
the kernel table, and, last, ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and int32 ALU ops —
# 64 INT32 lanes x 132 SMs x 1.98 GHz, a quarter of the 67 TFLOP/s fp32
# figure (128 FP32 lanes, 2 FLOPs per FMA)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# rank-dictionary sizes: the kernel's timed input (5,120 blocks of 256
# words, 42 Mbit) and the entry point's bitmap, the size of the msq_aids
# q-gram tree's S_b that the JAX package's MSQIndex.size_bits() reports
RANK_WORDS = 1310720
RANK_BITS = 41996333


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def event_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median over ``trials`` of CUDA-event time per call, each trial
    ``reps`` back-to-back calls after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def profiler_device_ms(fn, kernel_name: str, reps: int = 20):
    """Mean device time of the CUDA kernel whose name contains
    ``kernel_name`` per call, from ``torch.profiler``; None when the
    profiler reports no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            total_us += float(dev_us)
            count += int(ev.count)
    if count == 0 or total_us <= 0.0:
        return None
    return total_us / count / 1e3


def profiled(fn):
    """(fn's result, device activity during it): kernel and copy time on
    the card from ``torch.profiler``, summed over its device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernel_us = copy_us = 0.0
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        if "memcpy" in ev.name.lower() or "memset" in ev.name.lower():
            copy_us += us
        else:
            kernel_us += us
            n_kernels += 1
    return out, {"kernel_ms": kernel_us / 1e3, "copy_ms": copy_us / 1e3,
                 "busy_ms": (kernel_us + copy_us) / 1e3,
                 "n_kernels": n_kernels}


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at main-path shapes
# ---------------------------------------------------------------------------

def filter_inputs(rng, Q=3, B=10000, U=1851, NV=62, NE=3, VM=56):
    """msq_aids-like operands of one bucket: sparse F_D rows (a molecule
    touches a few dozen of the 1851 degree q-grams), label histograms,
    non-increasing degree sequences, region coordinates and query
    geometry that make the floor-divided region numerators negative."""
    import numpy as np
    fd = (rng.random((B, U)) < 0.01) * rng.integers(1, 6, (B, U))
    vhist = (rng.random((B, NV)) < 0.1) * rng.integers(1, 20, (B, NV))
    ehist = rng.integers(0, 30, (B, NE))
    degseq = -np.sort(-rng.integers(0, 5, (B, VM)), axis=1)
    degseq[:, 40:] = 0
    aux = np.stack([rng.integers(5, 56, B), rng.integers(4, 60, B),
                    rng.integers(-8, 12, B), rng.integers(-8, 12, B)], 1)
    # self-consistent queries: label and q-gram counts sum to |V| / |E|
    q_nv, q_ne = rng.integers(5, 56, Q), rng.integers(4, 60, Q)
    qvh = np.stack([rng.multinomial(n, np.full(NV, 1 / NV)) for n in q_nv])
    qeh = np.stack([rng.multinomial(m, np.full(NE, 1 / NE)) for m in q_ne])
    qfd = np.zeros((Q, U), np.int64)
    for r in range(Q):
        cols = rng.choice(U, 20, replace=False)
        qfd[r, cols] = rng.multinomial(q_nv[r], np.full(20, 1 / 20))
    qsig = -np.sort(-rng.integers(0, 5, (Q, VM)), axis=1)
    x0, y0, l = rng.integers(0, 90, Q), rng.integers(0, 90, Q), \
        rng.integers(1, 6, Q)
    scalars = np.stack([q_nv, q_ne, rng.integers(0, 6, Q), x0, y0, l], 1)
    cdt = rng.integers(0, 8, (Q, B))
    # every 16th graph is a copy of a query placed at the corner of that
    # query's region (floor-divided, so often negative): bound 0, mask 1
    i1 = (q_ne - scalars[:, 2] + q_nv - (x0 + y0)) // l
    j1 = (q_ne - scalars[:, 2] - q_nv - (y0 - x0)) // l
    for b in range(0, B, 16):
        r = (b // 16) % Q
        fd[b], vhist[b], ehist[b], degseq[b] = qfd[r], qvh[r], qeh[r], qsig[r]
        aux[b] = (q_nv[r], q_ne[r], i1[r], j1[r])
    return [np.ascontiguousarray(x, np.int32) for x in
            (scalars, fd, qfd, vhist, qvh, ehist, qeh, degseq, qsig, aux,
             cdt)]


def lb_inputs(rng, Q=8, N=64, VMq=64, VM=56, NE=3, NVL=62):
    """Branch features of a query block and a survivor union: real
    vertices first, pads at label -1 / degree 0 / zero histograms."""
    import numpy as np
    qn = rng.integers(1, VMq + 1, Q)
    dn = rng.integers(0, VM + 1, N)

    def side(rows, vm, n):
        lab = rng.integers(0, NVL, (rows, vm))
        deg = rng.integers(1, 5, (rows, vm))
        eh = rng.integers(0, 3, (rows, vm, NE))
        live = np.arange(vm)[None, :] < n[:, None]
        lab[~live] = -1
        deg[~live] = 0
        eh[~live] = 0
        return lab, deg, eh

    qv, qd, qeh = side(Q, VMq, qn)
    dv, dd, deh = side(N, VM, dn)
    return [np.ascontiguousarray(x, np.int32) for x in
            (qv, qd, qeh, qn, dv, dd, deh, dn)]


def packed_inputs(rng, B=10240, U=1851):
    """A padded bucket's packed F_D rows as msq_aids gives them: sparse
    counts under 4 (width 2), and in 63% of the rows one count of 4..15
    in block 0, the most frequent degree q-grams (width 4) — 613,313
    width-2 and 26,992 width-4 blocks over the 42,687 graphs, W = 128
    words a row."""
    import numpy as np
    m = (rng.random((B, U)) < 0.02) * rng.integers(1, 4, (B, U))
    hot = np.flatnonzero(rng.random(B) < 0.63)
    m[hot, rng.integers(0, 128, len(hot))] = rng.integers(4, 16, len(hot))
    return m


def every_width_rows(m, rng):
    """``m`` with rows 0..4 holding one block at each width 2..32, the
    width-32 block with values >= 2**31 (negative as int32)."""
    import numpy as np
    m = m.copy()
    for r, top in enumerate((3, 15, 255, 65535, 2 ** 32 - 1)):
        m[r, 128 * r:128 * (r + 1)] = rng.integers(top // 2 + 1, top,
                                                   128, endpoint=True)
    return m


def phase_kernels(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.assign_lb import kernel as lbk
    from repro_torch.kernels.assign_lb import ref as lbref
    from repro_torch.kernels.bitunpack import kernel as buk
    from repro_torch.kernels.bitunpack import ops as buops
    from repro_torch.kernels.bitunpack import ref as buref
    from repro_torch.kernels.qgram_filter import kernel as qfk
    from repro_torch.kernels.qgram_filter import ops as qfops
    from repro_torch.kernels.qgram_filter import ref as qfref
    from repro_torch.kernels.rank_popcount import kernel as rpk
    from repro_torch.kernels.rank_popcount import ref as rpref

    rng = np.random.default_rng(0)
    rows = {}

    # --- kernel 1: the fused q-gram filter cascade
    host = filter_inputs(rng)
    t = [torch.from_numpy(x).to(dev) for x in host]
    args = qfops.pad_batched(*t)
    Qp, Bp, Up = args[0].shape[0], args[1].shape[0], args[1].shape[1]
    check((Qp, Bp, Up) == (8, 10240, 2048),
          f"filter padding gave {(Qp, Bp, Up)}")
    kb, km = qfk.fused_batched_call(*args)
    rb, rm = qfref.fused_batched_bounds(*args)
    torch.cuda.synchronize()
    err = max(int((kb - rb).abs().max()), int((km - rm).abs().max()))
    check(torch.equal(kb, rb) and torch.equal(km, rm),
          f"qgram_filter kernel != plain version (max abs err {err})")
    check(bool((rm[:3] > 0).any()) and bool((rm[:3] == 0).any()),
          "filter inputs exercise only one mask value")
    NV, NE, VM = args[3].shape[1], args[5].shape[1], args[7].shape[1]
    ops = Qp * Bp * (2 * Up + 2 * NV + 2 * NE + 6 * VM + 40)
    b_ms, b_by = bound_ms(nbytes_of(*args) + 2 * Qp * Bp * 4, ops)
    ev_ms = event_ms(lambda: qfk.fused_batched_call(*args))
    prof_ms = profiler_device_ms(lambda: qfk.fused_batched_call(*args),
                                 "qgram_filter_kernel")
    plain_ms = event_ms(lambda: qfref.fused_batched_bounds(*args), reps=5,
                        trials=3)
    rows["qgram_filter"] = dict(
        name="qgram_filter", route="cuda",
        source="src/repro_torch/csrc/qgram_filter.cu",
        replaces="src/repro/kernels/qgram_filter/kernel.py:247",
        launches=None, max_abs_err=float(err),
        ms=prof_ms if prof_ms is not None else ev_ms,
        timed_by="profiler" if prof_ms is not None else "events",
        event_ms=ev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=dict(Q=Qp, B=Bp, U=Up, NV=NV, NE=NE, VM=VM))
    print(f"[kernels] qgram_filter Q={Qp} B={Bp} U={Up}: equal to plain; "
          f"kernel {rows['qgram_filter']['ms']:.4f} ms "
          f"({rows['qgram_filter']['timed_by']}; events {ev_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)

    # --- kernel 2: the assignment lower bound
    lt = [torch.from_numpy(x).to(dev) for x in lb_inputs(rng)]
    ko = lbk.assign_lb_call(*lt)
    ro = lbref.batched_assign_lb(*lt)
    torch.cuda.synchronize()
    err2 = int((ko - ro).abs().max())
    check(torch.equal(ko, ro),
          f"assign_lb kernel != plain version (max abs err {err2})")
    (Q, VMq), (N, VM2), NE2 = lt[0].shape, lt[4].shape, lt[6].shape[2]
    ops2 = Q * N * VMq * VM2 * (6 + 2 * NE2)
    b2_ms, b2_by = bound_ms(nbytes_of(*lt) + Q * N * 4, ops2)
    ev2 = event_ms(lambda: lbk.assign_lb_call(*lt))
    prof2 = profiler_device_ms(lambda: lbk.assign_lb_call(*lt),
                               "assign_lb_kernel")
    plain2 = event_ms(lambda: lbref.batched_assign_lb(*lt), reps=5, trials=3)
    rows["assign_lb"] = dict(
        name="assign_lb", route="cuda",
        source="src/repro_torch/csrc/assign_lb.cu",
        replaces="src/repro/kernels/assign_lb/kernel.py:78",
        launches=None, max_abs_err=float(err2),
        ms=prof2 if prof2 is not None else ev2,
        timed_by="profiler" if prof2 is not None else "events",
        event_ms=ev2, plain_ms=plain2, bound_ms=b2_ms, bound_by=b2_by,
        library_ms=None, shape=dict(Q=Q, N=N, VMq=VMq, VM=VM2, NE=NE2))
    print(f"[kernels] assign_lb Q={Q} N={N} VMq={VMq} VM={VM2}: equal to "
          f"plain; kernel {rows['assign_lb']['ms']:.4f} ms "
          f"({rows['assign_lb']['timed_by']}; events {ev2:.4f} ms), "
          f"plain {plain2:.4f} ms, bound {b2_ms:.5f} ms ({b2_by})",
          flush=True)

    # --- kernel 3: the packed slab's row decode into the padded F_D block
    m = packed_inputs(rng)
    pk = buops.pack_hybrid_rows(m)
    (B3, KB), W = pk.sb.shape, pk.words.shape[1]
    out_cols = qfops.shape_bucket(pk.n_entries, qfops.U_BASE, qfops.U_CAP)
    bt = [torch.from_numpy(x).to(dev) for x in (pk.sb, pk.widths, pk.words)]
    check((B3, KB, W, out_cols) == (10240, 15, 128, 2048),
          f"bit-unpack shapes gave {(B3, KB, W, out_cols)}")
    ko = buk.bitunpack_call(*bt, out_cols)
    ro = buref.bitunpack(*bt, out_cols)
    torch.cuda.synchronize()
    err3 = int((ko - ro).abs().max())
    check(torch.equal(ko, ro),
          f"bitunpack kernel != plain version (max abs err {err3})")
    check(np.array_equal(ko[:, :pk.n_entries].cpu().numpy(), m),
          "bitunpack does not give back the packed counts")
    # every width, 32 included, at the same rows and blocks (W grows)
    pk_all = buops.pack_hybrid_rows(every_width_rows(m, rng))
    at = [torch.from_numpy(x).to(dev)
          for x in (pk_all.sb, pk_all.widths, pk_all.words)]
    ka, ra = buk.bitunpack_call(*at, out_cols), buref.bitunpack(*at, out_cols)
    fw, fsb, fwd = (torch.from_numpy(x).to(dev)
                    for x in buops.flatten_packed_rows(pk_all))
    kf = buk.bitunpack_call(fsb, fwd, fw)
    torch.cuda.synchronize()
    check(set(pk_all.widths.ravel().tolist()) == set(buops.WIDTHS),
          "the every-width rows miss a width")
    err3 = max(err3, int((ka.long() - ra.long()).abs().max()))
    check(torch.equal(ka, ra) and bool((ka[4, 512:640] < 0).all()),
          f"bitunpack kernel != plain version at every width "
          f"(max abs err {err3})")
    check(torch.equal(kf, buref.bitunpack(fsb, fwd, fw))
          and torch.equal(kf.reshape(B3, -1), ka[:, :KB * 128]),
          "bitunpack flat form != row form")
    n_entries = B3 * KB * 128
    b3_ms, b3_by = bound_ms(nbytes_of(*bt) + B3 * out_cols * 4,
                            6 * n_entries)
    ev3 = event_ms(lambda: buk.bitunpack_call(*bt, out_cols))
    prof3 = profiler_device_ms(lambda: buk.bitunpack_call(*bt, out_cols),
                               "bitunpack_kernel")
    plain3 = event_ms(lambda: buref.bitunpack(*bt, out_cols), reps=5,
                      trials=3)
    rows["bitunpack"] = dict(
        name="bitunpack", route="cuda",
        source="src/repro_torch/csrc/bitunpack.cu",
        replaces="src/repro/kernels/bitunpack/kernel.py:65",
        launches=None, max_abs_err=float(err3),
        ms=prof3 if prof3 is not None else ev3,
        timed_by="profiler" if prof3 is not None else "events",
        event_ms=ev3, plain_ms=plain3, bound_ms=b3_ms, bound_by=b3_by,
        library_ms=None,
        shape=dict(B=B3, KB=KB, W=W, out_cols=out_cols,
                   widths={int(w): int((pk.widths == w).sum())
                           for w in np.unique(pk.widths)}))
    print(f"[kernels] bitunpack B={B3} KB={KB} W={W} -> ({B3}, {out_cols}) "
          f"and every width to 32: equal to plain; kernel "
          f"{rows['bitunpack']['ms']:.4f} ms ({rows['bitunpack']['timed_by']}"
          f"; events {ev3:.4f} ms), plain {plain3:.4f} ms, bound "
          f"{b3_ms:.4f} ms ({b3_by})", flush=True)

    # --- kernel 4: the single-query cascade, C_D seeded from aux column 4
    sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig, aux, cdt = (
        torch.from_numpy(x).to(dev) for x in filter_inputs(rng, Q=1))
    aux5 = torch.cat([aux, cdt[0][:, None]], 1)
    sargs = qfops.pad_single(sc[0], fd, qfd[0], vh, qvh[0], eh, qeh[0], ds,
                             qsig[0], aux5)
    B4, U4 = sargs[1].shape
    check((B4, U4) == (10240, 2048), f"single padding gave {(B4, U4)}")
    kb4, km4 = qfk.fused_filter_call(*sargs)
    rb4, rm4 = qfref.fused_filter_bounds(*sargs)
    torch.cuda.synchronize()
    err4 = max(int((kb4 - rb4).abs().max()), int((km4 - rm4).abs().max()))
    check(torch.equal(kb4, rb4) and torch.equal(km4, rm4),
          f"single-query filter kernel != plain version (max abs err "
          f"{err4})")
    check(bool((rm4 > 0).any()) and bool((rm4 == 0).any()),
          "single-query inputs exercise only one mask value")
    NV4, NE4, VM4 = sargs[3].shape[1], sargs[5].shape[1], sargs[7].shape[1]
    b4_ms, b4_by = bound_ms(nbytes_of(*sargs) + 2 * B4 * 4,
                            B4 * (2 * U4 + 2 * NV4 + 2 * NE4 + 6 * VM4 + 40))
    ev4 = event_ms(lambda: qfk.fused_filter_call(*sargs))
    prof4 = profiler_device_ms(lambda: qfk.fused_filter_call(*sargs),
                               "qgram_filter_kernel<1")
    plain4 = event_ms(lambda: qfref.fused_filter_bounds(*sargs), reps=5,
                      trials=3)
    rows["qgram_filter_single"] = dict(
        name="qgram_filter_single", route="cuda",
        source="src/repro_torch/csrc/qgram_filter.cu",
        replaces="src/repro/kernels/qgram_filter/kernel.py:123",
        launches=None, max_abs_err=float(err4),
        ms=prof4 if prof4 is not None else ev4,
        timed_by="profiler" if prof4 is not None else "events",
        event_ms=ev4, plain_ms=plain4, bound_ms=b4_ms, bound_by=b4_by,
        library_ms=None, shape=dict(B=B4, U=U4, NV=NV4, NE=NE4, VM=VM4))
    print(f"[kernels] qgram_filter_single B={B4} U={U4}: equal to plain; "
          f"kernel {rows['qgram_filter_single']['ms']:.4f} ms "
          f"({rows['qgram_filter_single']['timed_by']}; events {ev4:.4f} "
          f"ms), plain {plain4:.4f} ms, bound {b4_ms:.4f} ms ({b4_by})",
          flush=True)

    # --- kernel 5: rank-directory block popcounts over a 42 Mbit bitmap
    n_words = RANK_WORDS
    wnp = rng.integers(0, 2 ** 32, n_words, dtype=np.uint32)
    wnp[: n_words // 4] &= rng.integers(0, 2 ** 32, n_words // 4,
                                        dtype=np.uint32)   # sparser quarter
    wnp[-256:] = 0xFFFFFFFF
    words = torch.from_numpy(wnp.view(np.int32)).to(dev)
    k5 = rpk.block_popcounts(words)
    r5 = rpref.block_popcounts_ref(words)
    torch.cuda.synchronize()
    err5 = int((k5 - r5).abs().max())
    check(torch.equal(k5, r5) and int(k5[-1]) == 256 * 32,
          f"block_popcounts kernel != plain version (max abs err {err5})")
    b5_ms, b5_by = bound_ms(nbytes_of(words, k5), 2 * n_words)
    ev5 = event_ms(lambda: rpk.block_popcounts(words))
    prof5 = profiler_device_ms(lambda: rpk.block_popcounts(words),
                               "block_popcount_kernel")
    plain5 = event_ms(lambda: rpref.block_popcounts_ref(words), reps=5,
                      trials=3)
    rows["rank_popcount"] = dict(
        name="rank_popcount", route="cuda",
        source="src/repro_torch/csrc/rank_popcount.cu",
        replaces="src/repro/kernels/rank_popcount/kernel.py:38",
        launches=None, max_abs_err=float(err5),
        ms=prof5 if prof5 is not None else ev5,
        timed_by="profiler" if prof5 is not None else "events",
        event_ms=ev5, plain_ms=plain5, bound_ms=b5_ms, bound_by=b5_by,
        library_ms=None, shape=dict(words=n_words, blocks=n_words // 256))
    print(f"[kernels] rank_popcount {n_words} words ({n_words * 32} bits, "
          f"{n_words // 256} blocks): equal to plain; kernel "
          f"{rows['rank_popcount']['ms']:.4f} ms "
          f"({rows['rank_popcount']['timed_by']}; events {ev5:.4f} ms), "
          f"plain {plain5:.4f} ms, bound {b5_ms:.5f} ms ({b5_by})",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the slice at full msq_aids scale
# ---------------------------------------------------------------------------

def make_queries(db, num: int = 64, edits: int = 2, seed: int = 7):
    import numpy as np
    from repro_torch.graphs.generators import perturb_graph
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(db), size=num, replace=True)
    return [perturb_graph(db[int(i)], edits, rng, db.n_vlabels,
                          db.n_elabels) for i in idx]


def phase_slice(dev, n_queries: int = 64, tau: int = 3):
    import numpy as np
    from repro_torch.configs.msq_aids import get_config
    from repro_torch.core.engine import bucket_queries
    from repro_torch.core.search import FlatMSQIndex
    from repro_torch.graphs.generators import aids_like_db
    from repro_torch.kernels.assign_lb.kernel import assign_lb_call
    from repro_torch.kernels.bitunpack.kernel import bitunpack_call
    from repro_torch.kernels.qgram_filter import ops as qf_ops
    from repro_torch.kernels.qgram_filter.kernel import fused_batched_call
    from repro_torch.serve.graph_engine import GraphQuery, GraphQueryEngine

    cfg = get_config()
    t0 = time.perf_counter()
    db = aids_like_db(cfg.num_graphs, seed=cfg.seed,
                      n_vlabels=cfg.n_vlabels, n_elabels=cfg.n_elabels)
    idx = FlatMSQIndex(db, l=cfg.subregion_l)
    graphs = make_queries(db, n_queries)
    taus = [tau] * len(graphs)
    reqs = [GraphQuery(g, tau) for g in graphs]
    buckets = bucket_queries(idx.partition, graphs, taus)
    st = db.stats()
    print(f"[slice] {cfg.name}: {st['num_graphs']} graphs (avg |V| "
          f"{st['avg_V']:.1f}, avg |E| {st['avg_E']:.1f}, max |V| "
          f"{st['max_V']}), U={idx.vocab.n_degree_ids}, {len(graphs)} "
          f"queries at tau={tau} in {len(buckets)} buckets; host build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    kw = dict(slab=cfg.slab_layout, assign_lb=cfg.assign_lb,
              lb_hungarian=cfg.lb_hungarian)
    out = {}
    for backend in ("cuda", "torch", "numpy"):
        eng = GraphQueryEngine(idx, backend=backend,
                               device=None if backend == "numpy" else dev,
                               slab_layout=cfg.slab_layout,
                               assign_lb=cfg.assign_lb,
                               lb_hungarian=cfg.lb_hungarian)
        t1 = time.perf_counter()
        ev = idx.filter_eval(backend, device=eng.device, **kw)
        slab_s = time.perf_counter() - t1
        if backend == "cuda":
            sizes = [len(ev.graphs_in_rect(r)) for r in buckets]
            up = qf_ops.shape_bucket(ev.slab.U, qf_ops.U_BASE, qf_ops.U_CAP)
            fd_mb = sum(qf_ops.shape_bucket(n, qf_ops.B_BASE, qf_ops.B_CAP)
                        * up * 4 for n in sizes if n) / 1e6
            print(f"[slice] buckets hold {min(sizes)}..{max(sizes)} graphs "
                  f"({sum(sizes)} in all); F_D gathered and uploaded per "
                  f"batch on a cold cache: {fd_mb:.0f} MB", flush=True)
            # the main path's run: counters read just around it
            fused_batched_call.launches = 0
            assign_lb_call.launches = 0
        t1 = time.perf_counter()
        res = eng.submit(reqs)
        wall = time.perf_counter() - t1
        if backend == "cuda":
            launches = {"qgram_filter": fused_batched_call.launches,
                        "assign_lb": assign_lb_call.launches}
            # the host half of the filter stage on its own: the row
            # gathers of every bucket's padded sub-slab
            t3 = time.perf_counter()
            for rect in buckets:
                rows = ev.graphs_in_rect(rect)
                if len(rows):
                    ev.slab.gather(rows, qf_ops.shape_bucket(
                        len(rows), qf_ops.B_BASE, qf_ops.B_CAP))
            print(f"[slice] host row gathers of the {len(buckets)} "
                  f"buckets alone: {time.perf_counter() - t3:.3f} s",
                  flush=True)
        s = eng.stats.snapshot()
        print(f"[slice] backend={backend}: slab build {slab_s:.2f} s; "
              f"submit {wall:.3f} s (filter_s {s['filter_s']:.4f}, lb_s "
              f"{s['lb_s']:.4f}, verify_s {s['verify_s']:.3f}); "
              f"verified_pairs {s['verified_pairs']}, lb_pruned "
              f"{s['lb_pruned']}, lb_tightened {s['lb_tightened']}, "
              f"matches {sum(len(r.matches) for r in res)}; device cache "
              f"{ev.device_cache.snapshot()}", flush=True)
        # bounds and LBs come from the candidate stage itself: a second
        # pass after the engine run (the launch counters are already read)
        t2 = time.perf_counter()
        if backend == "cuda":
            batch, busy = profiled(lambda: idx.batched_candidates(
                graphs, taus, backend=backend, device=eng.device, **kw))
        else:
            batch = idx.batched_candidates(graphs, taus, backend=backend,
                                           device=eng.device, **kw)
        cand_s = time.perf_counter() - t2
        msg = ""
        if backend == "cuda":
            msg = (f"; device busy {busy['kernel_ms']:.3f} ms in kernels "
                   f"({busy['n_kernels']} launches) + {busy['copy_ms']:.3f}"
                   f" ms in copies = {100 * busy['busy_ms'] / 1e3 / cand_s:.2f}"
                   f"% of the pass")
        print(f"[slice] backend={backend}: second candidate pass "
              f"{cand_s:.4f} s{msg}", flush=True)
        out[backend] = (res, batch)

    ref_res, ref_batch = out["numpy"]
    n_filter = sum(1 for n in sizes if n)
    n_lb = sum(1 for qis in buckets.values()
               if any(ref_batch.ids[qi] for qi in qis))
    print(f"[slice] cuda launches on the main path: {launches} for "
          f"{len(buckets)} buckets ({n_filter} non-empty, {n_lb} with "
          f"survivors)", flush=True)
    check(launches["qgram_filter"] == n_filter,
          f"filter launches {launches['qgram_filter']} != non-empty buckets "
          f"{n_filter}")
    check(launches["assign_lb"] == n_lb,
          f"assign_lb launches {launches['assign_lb']} != buckets with "
          f"survivors {n_lb}")
    n_match = sum(len(r.matches) for r in ref_res)
    check(n_match > 0, "the batch found no matches")
    for backend in ("cuda", "torch"):
        res, batch = out[backend]
        check(batch.ids == ref_batch.ids, f"{backend}: candidates differ")
        for a, b in zip(batch.bounds, ref_batch.bounds):
            check(np.array_equal(a, b), f"{backend}: filter bounds differ")
        for a, b in zip(batch.lbs, ref_batch.lbs):
            check(np.array_equal(a, b), f"{backend}: LBs differ")
        for r, rr in zip(res, ref_res):
            check(r.candidates == rr.candidates,
                  f"{backend}: result candidates differ")
            check(r.matches == rr.matches, f"{backend}: matches differ")
    for r in ref_res:
        check(all(0 <= d <= tau for _, d in r.matches), "match beyond tau")
    print(f"[slice] cuda == torch == numpy: candidates "
          f"{sum(len(c) for c in ref_batch.ids)}, matches {n_match}",
          flush=True)

    # the packed slab: the succinct form stays resident, and every bucket
    # launch decodes it on the card (bit-unpack, then the filter)
    pkw = dict(kw, slab="packed")
    eng = GraphQueryEngine(idx, backend="cuda", device=dev,
                           slab_layout="packed", assign_lb=cfg.assign_lb,
                           lb_hungarian=cfg.lb_hungarian)
    t1 = time.perf_counter()
    ev_p = idx.filter_eval("cuda", device=dev, **pkw)
    slab_s = time.perf_counter() - t1
    pk = ev_p.slab.packed
    W, KB = pk.words.shape[1], pk.sb.shape[1]
    up = qf_ops.shape_bucket(ev_p.slab.U, qf_ops.U_BASE, qf_ops.U_CAP)
    pads = [qf_ops.shape_bucket(n, qf_ops.B_BASE, qf_ops.B_CAP)
            for n in sizes if n]
    print(f"[packed] slab build {slab_s:.2f} s; W={W} words, KB={KB} blocks "
          f"a row; packed rows uploaded per batch on a cold cache: "
          f"{sum(pads) * (W + 2 * KB) * 4 / 1e6:.1f} MB; decoded on the card"
          f" per batch: {sum(pads) * up * 4 / 1e6:.0f} MB", flush=True)
    sizes_bits = {lay: idx.filter_eval("numpy", slab=lay).slab.size_bits()
                  for lay in ("dense", "packed")}
    ratio = sizes_bits["dense"]["total"] / sizes_bits["packed"]["total"]
    print(f"[packed] FilterSlab.size_bits(): dense {sizes_bits['dense']}, "
          f"packed {sizes_bits['packed']} ({ratio:.2f}x smaller)",
          flush=True)
    # the packed path's run: counters read just around it
    fused_batched_call.launches = 0
    assign_lb_call.launches = 0
    bitunpack_call.launches = 0
    t1 = time.perf_counter()
    p_res = eng.submit(reqs)
    wall = time.perf_counter() - t1
    p_launches = {"bitunpack": bitunpack_call.launches,
                  "qgram_filter": fused_batched_call.launches,
                  "assign_lb": assign_lb_call.launches}
    s = eng.stats.snapshot()
    print(f"[packed] backend=cuda: submit {wall:.3f} s (filter_s "
          f"{s['filter_s']:.4f}, lb_s {s['lb_s']:.4f}, verify_s "
          f"{s['verify_s']:.3f}); verified_pairs {s['verified_pairs']}, "
          f"matches {sum(len(r.matches) for r in p_res)}; launches "
          f"{p_launches} for {n_filter} non-empty buckets; device cache "
          f"{ev_p.device_cache.snapshot()}", flush=True)
    t2 = time.perf_counter()
    p_batch, busy = profiled(lambda: idx.batched_candidates(
        graphs, taus, backend="cuda", device=dev, **pkw))
    cand_s = time.perf_counter() - t2
    print(f"[packed] backend=cuda: second candidate pass {cand_s:.4f} s; "
          f"device busy {busy['kernel_ms']:.3f} ms in kernels "
          f"({busy['n_kernels']} launches) + {busy['copy_ms']:.3f} ms in "
          f"copies = {100 * busy['busy_ms'] / 1e3 / cand_s:.2f}% of the pass",
          flush=True)
    check(p_launches["bitunpack"] == n_filter
          and p_launches["qgram_filter"] == n_filter,
          f"packed launches {p_launches} != one bit-unpack and one filter "
          f"per non-empty bucket ({n_filter})")
    check(p_launches["assign_lb"] == n_lb,
          f"packed assign_lb launches {p_launches['assign_lb']} != buckets "
          f"with survivors {n_lb}")
    batches = {"cuda": p_batch}
    for backend in ("torch", "numpy"):
        t2 = time.perf_counter()
        batches[backend] = idx.batched_candidates(
            graphs, taus, backend=backend,
            device=None if backend == "numpy" else dev, **pkw)
        print(f"[packed] backend={backend}: candidate pass "
              f"{time.perf_counter() - t2:.4f} s", flush=True)
    for backend, batch in batches.items():
        check(batch.ids == ref_batch.ids,
              f"packed {backend}: candidates differ from dense")
        for a, b in zip(batch.bounds, ref_batch.bounds):
            check(np.array_equal(a, b),
                  f"packed {backend}: filter bounds differ from dense")
        for a, b in zip(batch.lbs, ref_batch.lbs):
            check(np.array_equal(a, b),
                  f"packed {backend}: LBs differ from dense")
    for r, rr in zip(p_res, ref_res):
        check(r.candidates == rr.candidates and r.matches == rr.matches,
              "packed cuda: result candidates or matches differ from dense")
    print(f"[packed] cuda, torch, numpy on packed == dense: candidates, "
          f"bounds, LBs, matches ({n_match} matches)", flush=True)
    return {name: {"dense": launches.get(name), "packed": p_launches[name]}
            for name in p_launches}, idx, graphs[0], tau


def phase_entry_points(dev, idx, h, tau):
    """Kernels 4 and 5 through their public entry points, each a path of
    its own with its counter reset just before and read just after: one
    query's single-query cascade over the whole msq_aids slab, held
    against the host scalar oracle, and a rank dictionary over a
    41,996,333-bit bitmap (the msq_aids q-gram tree's S_b size), held
    against the plain version and a numpy prefix count."""
    import numpy as np
    import torch
    from repro_torch.kernels.qgram_filter import ops as qf_ops
    from repro_torch.kernels.qgram_filter.kernel import fused_filter_call
    from repro_torch.kernels.rank_popcount import ops as rp_ops
    from repro_torch.kernels.rank_popcount import ref as rp_ref
    from repro_torch.kernels.rank_popcount.kernel import block_popcounts

    ev = idx.filter_eval("numpy")
    sl, p = ev.slab, idx.partition
    q = ev.query_arrays(h, tau)
    aux = np.stack([sl.nv, sl.ne, sl.region_i, sl.region_j,
                    np.zeros_like(sl.nv)], 1)
    t = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
         for x in ([q.nv, q.ne, tau, p.x0, p.y0, p.l], sl.fd, q.fd,
                   sl.vhist, q.vhist, sl.ehist, q.ehist, sl.degseq, q.sigma,
                   aux)]
    fused_filter_call.launches = 0
    t0 = time.perf_counter()
    _, mask = qf_ops.fused_filter_bounds(*t)
    got = np.flatnonzero(mask.cpu().numpy()).tolist()
    single_s = time.perf_counter() - t0
    n4 = fused_filter_call.launches
    want = idx.candidates(h, tau)
    check(n4 == 1, f"single-query entry point launched {n4} kernels")
    check(got == want and len(want) > 0,
          f"single-query candidates {len(got)} != host oracle's {len(want)}")
    print(f"[entry] fused_filter_bounds: one query over all {sl.B} graphs "
          f"in {single_s:.4f} s (upload included), {len(got)} candidates "
          f"== FlatMSQIndex.candidates; launches {n4}", flush=True)

    rng = np.random.default_rng(11)
    n_bits = RANK_BITS
    bits = (rng.random(n_bits) < 0.3).astype(np.uint8)
    qidx = np.concatenate([rng.integers(0, n_bits + 1, 4096), [0, n_bits]])
    block_popcounts.launches = 0
    t0 = time.perf_counter()
    words, cum = rp_ops.build_rank_dictionary(bits, dev)
    ranks = rp_ops.rank1_query(words, cum, torch.from_numpy(qidx).to(dev))
    torch.cuda.synchronize()
    rank_s = time.perf_counter() - t0
    n5 = block_popcounts.launches
    check(n5 == 1, f"rank dictionary entry point launched {n5} kernels")
    prefix = np.concatenate([[0], np.cumsum(bits, dtype=np.int64)])
    check(np.array_equal(ranks.cpu().numpy(), prefix[qidx]),
          "rank1_query != numpy prefix count")
    check(torch.equal(ranks, rp_ref.rank1_query_ref(
        words, torch.from_numpy(qidx).to(dev))), "rank1_query != plain")
    print(f"[entry] build_rank_dictionary + rank1_query: {n_bits} bits, "
          f"{len(words) // 256} blocks, {len(qidx)} queries in {rank_s:.4f}"
          f" s (pack and upload included) == numpy prefix count; launches "
          f"{n5}", flush=True)
    return {"qgram_filter_single": n4, "rank_popcount": n5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all")
    ap.add_argument("--verbose-build", action="store_true")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    from repro_torch.kernels._lib import LIBRARY
    t0 = time.perf_counter()
    LIBRARY.build(verbose=args.verbose_build)
    LIBRARY.get()
    print(f"[build] nvcc build + load {time.perf_counter() - t0:.2f} s "
          f"(built this run: {LIBRARY.built})", flush=True)
    if args.verbose_build:
        print(LIBRARY.compiler_log, flush=True)

    rows = phase_kernels(dev)
    if args.phase == "all":
        by_path, idx, h, tau = phase_slice(dev)
        for name, n in by_path.items():
            # the dense path's count where it runs the kernel, else the
            # packed path's (the bit-unpack kernel runs on packed only)
            rows[name]["launches"] = int(n["dense"] if n["dense"] is not None
                                         else n["packed"])
            rows[name]["launches_by_path"] = n
        for name, n in phase_entry_points(dev, idx, h, tau).items():
            rows[name]["launches"] = int(n)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
