"""The port's CUDA kernels and ``cuda`` backend on the card.

Every test here needs a CUDA device and skips without one; none imports
JAX, so the file runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version on the same CUDA tensors
(int32 throughout: tolerance zero), the wrappers must raise on operands
the kernels do not take instead of stepping down to the plain version,
and the ``cuda`` backend must give the ``numpy`` backend's candidates,
bounds, LBs and matches with every filter pass launched as a kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.assign_lb import kernel as lbk
from repro_torch.kernels.assign_lb import ops as lbops
from repro_torch.kernels.assign_lb import ref as lbref
from repro_torch.kernels.bitunpack import kernel as buk
from repro_torch.kernels.bitunpack import ops as buops
from repro_torch.kernels.bitunpack import ref as buref
from repro_torch.kernels.qgram_filter import kernel as qfk
from repro_torch.kernels.qgram_filter import ops as qfops
from repro_torch.kernels.qgram_filter import ref as qfref
from repro_torch.kernels.rank_popcount import kernel as rpk
from repro_torch.kernels.rank_popcount import ops as rpops
from repro_torch.kernels.rank_popcount import ref as rpref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _filter_case(rng, Q, B, U, NV=62, NE=3, VM=40):
    fd = (rng.random((B, U)) < 0.05) * rng.integers(1, 5, (B, U))
    vh = rng.integers(0, 5, (B, NV))
    eh = rng.integers(0, 9, (B, NE))
    ds = -np.sort(-rng.integers(0, 6, (B, VM)), axis=1)
    aux = np.concatenate([rng.integers(1, 60, (B, 2)),
                          rng.integers(-9, 5, (B, 2))], 1)
    sc = np.concatenate([rng.integers(1, 60, (Q, 3)) % [60, 60, 6],
                         rng.integers(0, 80, (Q, 2)),
                         rng.integers(1, 6, (Q, 1))], 1)
    # self-consistent queries: label and degree-q-gram counts sum to |V|
    qvh = (rng.random((Q, NV)) < 0.2) * rng.integers(1, 4, (Q, NV))
    qeh = rng.integers(0, 9, (Q, NE))
    sc[:, 0], sc[:, 1] = qvh.sum(1), qeh.sum(1)
    qfd = np.zeros((Q, U), np.int64)
    for r in range(Q):
        cols = rng.choice(U, min(U, 12), replace=False)
        qfd[r, cols] = rng.multinomial(sc[r, 0], np.full(len(cols),
                                                         1 / len(cols)))
    qsig = -np.sort(-rng.integers(0, 6, (Q, VM)), axis=1)
    s = sc.astype(np.int64)
    i1 = (s[:, 1] - s[:, 2] + s[:, 0] - (s[:, 3] + s[:, 4])) // s[:, 5]
    j1 = (s[:, 1] - s[:, 2] - s[:, 0] - (s[:, 4] - s[:, 3])) // s[:, 5]
    for b in range(0, B, 7):       # planted copies: bound 0, in region
        r = (b // 7) % Q
        fd[b], vh[b], eh[b], ds[b] = qfd[r], qvh[r], qeh[r], qsig[r]
        aux[b] = (sc[r, 0], sc[r, 1], i1[r], j1[r])
    cdt = rng.integers(0, 4, (Q, B))
    return [torch.from_numpy(np.ascontiguousarray(x, np.int32)) for x in
            (sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig, aux, cdt)]


@pytest.mark.parametrize("Q,B,U,with_cdt", [
    (1, 7, 33, True), (3, 1000, 1851, True), (13, 97, 515, False),
    (64, 600, 130, True),
])
def test_filter_kernel_equals_plain_version(cuda, Q, B, U, with_cdt):
    rng = np.random.default_rng(Q * 100 + B)
    case = [t.to(cuda) for t in _filter_case(rng, Q, B, U)]
    if not with_cdt:
        case[-1] = None
    args = qfops.pad_batched(*case)
    before = qfk.fused_batched_call.launches
    kb, km = qfk.fused_batched_call(*args)
    rb, rm = qfref.fused_batched_bounds(*args)
    torch.cuda.synchronize()
    assert qfk.fused_batched_call.launches == before + 1
    assert torch.equal(kb, rb) and torch.equal(km, rm)
    assert int(km[:Q].sum()) > 0


def _lb_case(rng, Q, N, vmq, vm):
    qn = rng.integers(1, vmq + 1, Q)
    dn = rng.integers(0, vm + 1, N)

    def side(rows, width, n):
        lab = rng.integers(0, 6, (rows, width))
        eh = rng.integers(0, 3, (rows, width, 3))
        live = np.arange(width)[None, :] < n[:, None]
        lab[~live] = -1
        eh[~live] = 0
        return lab, eh.sum(-1), eh

    qv, qd, qeh = side(Q, vmq, qn)
    dv, dd, deh = side(N, vm, dn)
    qv, qd, qeh, qn = lbops.pad_query_block(qv, qd, qeh, qn)
    return [torch.from_numpy(np.ascontiguousarray(x, np.int32)) for x in
            (qv, qd, qeh, qn, dv, dd, deh, dn)]


@pytest.mark.parametrize("Q,N,VMq,VM", [
    (1, 8, 5, 9), (8, 64, 64, 56), (13, 130, 30, 40), (3, 512, 17, 200),
])
def test_assign_lb_kernel_equals_plain_version(cuda, Q, N, VMq, VM):
    rng = np.random.default_rng(Q + N)
    case = [t.to(cuda) for t in _lb_case(rng, Q, N, VMq, VM)]
    before = lbk.assign_lb_call.launches
    got = lbk.assign_lb_call(*case)
    want = lbref.batched_assign_lb(*case)
    torch.cuda.synchronize()
    assert lbk.assign_lb_call.launches == before + 1
    assert torch.equal(got, want)


def test_wrappers_raise_instead_of_stepping_down(cuda):
    rng = np.random.default_rng(1)
    args = list(qfops.pad_batched(*[t.to(cuda) for t in
                                    _filter_case(rng, 3, 50, 64)]))
    before = qfk.fused_batched_call.launches
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError):
        qfk.fused_batched_call(*bad)
    bad = list(args)
    bad[1] = bad[1].t().contiguous().t()
    with pytest.raises(ValueError):
        qfk.fused_batched_call(*bad)
    bad = list(args)
    bad[0] = bad[0][:3]                   # Q not on the kernel's multiple
    with pytest.raises(ValueError):
        qfk.fused_batched_call(*bad)
    bad = list(args)
    bad[2] = bad[2].cpu()                 # mixed devices
    with pytest.raises(ValueError):
        qfk.fused_batched_call(*bad)
    assert qfk.fused_batched_call.launches == before
    lb = [t.to(cuda) for t in _lb_case(rng, 2, 8, 4, 300)]
    with pytest.raises(ValueError):       # VM past what a warp holds
        lbk.assign_lb_call(*lb)


def test_cuda_backend_equals_numpy_backend(cuda):
    from repro_torch.core.engine import bucket_queries
    from repro_torch.core.search import FlatMSQIndex
    from repro_torch.graphs.generators import aids_like_db, perturb_graph
    from repro_torch.serve.graph_engine import GraphQuery, GraphQueryEngine
    db = aids_like_db(400, seed=3)
    idx = FlatMSQIndex(db)
    rng = np.random.default_rng(5)
    graphs = [perturb_graph(db[int(i)], 2, rng, db.n_vlabels, db.n_elabels)
              for i in rng.choice(len(db), 16)]
    for layout in ("dense", "hot"):
        taus = [3] * len(graphs)
        n_buckets = sum(
            1 for r in bucket_queries(idx.partition, graphs, taus)
            if len(idx.filter_eval("numpy", slab=layout).graphs_in_rect(r)))
        before = qfk.fused_batched_call.launches
        lb_before = lbk.assign_lb_call.launches
        eng = GraphQueryEngine(idx, slab_layout=layout)     # cuda default
        got = eng.submit([GraphQuery(g, 3) for g in graphs])
        assert qfk.fused_batched_call.launches == before + n_buckets
        assert lbk.assign_lb_call.launches > lb_before
        want = GraphQueryEngine(idx, backend="numpy", slab_layout=layout
                                ).submit([GraphQuery(g, 3) for g in graphs])
        for a, b in zip(got, want):
            assert a.candidates == b.candidates and a.matches == b.matches
        topk = eng.query_topk(graphs[0], k=3, cap=4)
        want_topk = GraphQueryEngine(idx, backend="numpy",
                                     slab_layout=layout).query_topk(
            graphs[0], k=3, cap=4)
        assert topk.matches == want_topk.matches
        assert topk.candidates == want_topk.candidates
        cb = idx.batched_candidates(graphs, taus, slab=layout)
        nb = idx.batched_candidates(graphs, taus, backend="numpy",
                                    slab=layout)
        assert cb.ids == nb.ids
        for x, y in zip(cb.bounds + cb.lbs, nb.bounds + nb.lbs):
            assert np.array_equal(x, y)


def _packed_case(rng, B, U):
    """Row-packed counts that hit every width, 32 with values >= 2**31."""
    m = (rng.random((B, U)) < 0.05) * rng.integers(1, 4, (B, U))
    tops = [3, 15, 255, 65535, 2 ** 32 - 1]
    for r in range(min(B, len(tops))):
        m[r, :min(U, 128)] = rng.integers(0, tops[r], min(U, 128),
                                          endpoint=True)
        m[r, 0] = tops[r]
    return buops.pack_hybrid_rows(m), m


@pytest.mark.parametrize("B,U,out_cols", [
    (1, 5, 128), (7, 300, 512), (100, 1851, 2048), (33, 129, 256),
])
def test_bitunpack_kernel_equals_plain_version(cuda, B, U, out_cols):
    rng = np.random.default_rng(B + U)
    pk, m = _packed_case(rng, B, U)
    t = [torch.from_numpy(x).to(cuda) for x in (pk.sb, pk.widths, pk.words)]
    before = buk.bitunpack_call.launches
    got = buk.bitunpack_call(*t, out_cols)
    want = buref.bitunpack(*t, out_cols)
    words, sb, widths = buops.flatten_packed_rows(pk)
    f = [torch.from_numpy(x).to(cuda) for x in (sb, widths, words)]
    flat = buk.bitunpack_call(*f)
    torch.cuda.synchronize()
    assert buk.bitunpack_call.launches == before + 2
    assert torch.equal(got, want) and got.shape == (B, out_cols)
    assert torch.equal(flat, buref.bitunpack(*f))
    assert torch.equal(flat.reshape(B, -1), got[:, :flat.numel() // B])
    assert np.array_equal(got[:, :U].cpu().numpy(),
                          m.astype(np.uint32).view(np.int32))


def test_single_query_filter_kernel_equals_plain_version(cuda):
    rng = np.random.default_rng(8)
    case = _filter_case(rng, 1, 3000, 1851)
    sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig, aux, cdt = case
    aux5 = torch.cat([aux, cdt[0][:, None]], 1)
    args = [x.to(cuda) for x in (sc[0], fd, qfd[0], vh, qvh[0], eh, qeh[0],
                                 ds, qsig[0], aux5)]
    before = qfk.fused_filter_call.launches
    kb, km = qfops.fused_filter_bounds(*args)
    rb, rm = qfops.fused_filter_bounds(*args, fn=qfref.fused_filter_bounds)
    torch.cuda.synchronize()
    assert qfk.fused_filter_call.launches == before + 1
    assert torch.equal(kb, rb) and torch.equal(km, rm)
    assert 0 < int(km.sum()) < len(km)
    # the seed is aux column 4: the batched kernel with cdt agrees
    bb, bm = qfops.fused_filter_bounds_batched(
        *[x.to(cuda) for x in (sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig,
                               aux, cdt)])
    assert torch.equal(bb[0], kb) and torch.equal(bm[0], km)


@pytest.mark.parametrize("n_bits", [1, 8192, 300000])
def test_rank_popcount_kernel_equals_plain_version(cuda, n_bits):
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, n_bits)
    words = torch.from_numpy(rpops.pack_bits_u32(bits).view(np.int32)
                             ).to(cuda)
    before = rpk.block_popcounts.launches
    got = rpk.block_popcounts(words)
    torch.cuda.synchronize()
    assert rpk.block_popcounts.launches == before + 1
    assert torch.equal(got, rpref.block_popcounts_ref(words))
    w, cum = rpops.build_rank_dictionary(bits)            # the card
    idx = torch.from_numpy(rng.integers(0, n_bits + 1, 64)).to(cuda)
    assert w.device.type == "cuda"
    assert torch.equal(rpops.rank1_query(w, cum, idx),
                       rpref.rank1_query_ref(w, idx))


def test_packed_slab_cuda_equals_torch_and_numpy(cuda):
    """The packed slab on the card: one bit-unpack launch and one filter
    launch per non-empty bucket, and the cuda backend's candidates,
    bounds, LBs and matches equal the torch (plain versions on the card)
    and numpy backends'."""
    from repro_torch.core.engine import bucket_queries
    from repro_torch.core.search import FlatMSQIndex
    from repro_torch.graphs.generators import aids_like_db, perturb_graph
    from repro_torch.serve.graph_engine import GraphQuery, GraphQueryEngine
    db = aids_like_db(400, seed=3)
    idx = FlatMSQIndex(db)
    rng = np.random.default_rng(6)
    graphs = [perturb_graph(db[int(i)], 2, rng, db.n_vlabels, db.n_elabels)
              for i in rng.choice(len(db), 16)]
    taus = [3] * len(graphs)
    ev = idx.filter_eval("numpy", slab="packed")
    n_buckets = sum(1 for r in bucket_queries(idx.partition, graphs, taus)
                    if len(ev.graphs_in_rect(r)))
    b0, f0 = buk.bitunpack_call.launches, qfk.fused_batched_call.launches
    cb = idx.batched_candidates(graphs, taus, slab="packed")
    assert buk.bitunpack_call.launches == b0 + n_buckets
    assert qfk.fused_batched_call.launches == f0 + n_buckets
    for kw in (dict(backend="torch", device=cuda), dict(backend="numpy")):
        other = idx.batched_candidates(graphs, taus, slab="packed", **kw)
        assert cb.ids == other.ids
        for x, y in zip(cb.bounds + cb.lbs, other.bounds + other.lbs):
            assert np.array_equal(x, y)
    got = GraphQueryEngine(idx, slab_layout="packed").submit(
        [GraphQuery(g, 3) for g in graphs])
    want = GraphQueryEngine(idx, backend="numpy").submit(
        [GraphQuery(g, 3) for g in graphs])
    for a, b in zip(got, want):
        assert a.candidates == b.candidates and a.matches == b.matches
