#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase (needs one card)
    python3 chip_smoke.py --phase kernels  # build + kernels vs plain only
    python3 chip_smoke.py --verbose-build  # also print ptxas -v output

Phases, each of which asserts and ends the run non-zero on failure:

1. **build**: compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process
   per source, all started together) into ``build/kernels/``, timed.
2. **kernels**: each CUDA kernel against its plain PyTorch version on the
   same CUDA tensors, at the shapes the msq_aids main path gives it
   (a 3-query bucket padded to Q=8, B=10,240 graphs, U=1851 padded to
   2048; the LB at Q=8, N=64, VMq=64, VM=56).  Every value is an int32,
   so the tolerance is zero.  Timed with CUDA events (and the profiler's
   device time where it reports one).
3. **slice**: the full msq_aids configuration (42,687 AIDS-like graphs,
   ``FlatMSQIndex``, dense slab, assignment LB on), one batch of 64 range
   queries at tau=3 (2-edit perturbations of database graphs, rng seed 7)
   through ``GraphQueryEngine`` on the ``cuda`` backend, with the kernel
   launch counters reset just before and read just after; then the same
   batch on the ``torch`` backend (plain versions on the card) and the
   ``numpy`` backend (host oracle).  Candidates, filter bounds, LBs and
   matches must be identical across the three.

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


def phase_kernels(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.assign_lb import kernel as lbk
    from repro_torch.kernels.assign_lb import ref as lbref
    from repro_torch.kernels.qgram_filter import kernel as qfk
    from repro_torch.kernels.qgram_filter import ops as qfops
    from repro_torch.kernels.qgram_filter import ref as qfref

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
    return launches


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
        launches = phase_slice(dev)
        for name, n in launches.items():
            rows[name]["launches"] = int(n)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
