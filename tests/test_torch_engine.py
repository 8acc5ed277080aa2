"""The slice as a whole: the port's ``GraphQueryEngine`` over a
``FlatMSQIndex`` held against the JAX package's on the CPU.

Both packages build the same database from the same seed (asserted), and
a batch of range queries goes through the JAX package's engine on its
``numpy`` backend and through the port's on ``backend='torch',
device='cpu'`` (the kernels' plain versions) and on ``backend='numpy'``.
Candidates, filter bounds, assignment LBs, matches and the worklist
counters (``verified_pairs``, ``lb_pruned``, ``lb_tightened``) must be
identical, on the dense, hot and packed slabs, with the LB stage on; on
the packed slab the JAX package's ``jax`` backend (which decodes the
packed rows with ``unpack_rows_ref``) is a second reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.msq_aids import get_config as j_get_config
from repro.core.search import FlatMSQIndex as JFlat
from repro.core.slab import FilterSlab as JSlab
from repro.core.slab import hot_d_from_mass as j_hot_d_from_mass
from repro.graphs import generators as jgen
from repro.graphs.graph import GraphDB as JGraphDB
from repro.serve.graph_engine import GraphQuery as JQuery
from repro.serve.graph_engine import GraphQueryEngine as JEngine
from repro_torch.configs.msq_aids import get_config
from repro_torch.convert import graphdb_from_arrays
from repro_torch.core.engine import bucket_queries
from repro_torch.core.search import FlatMSQIndex
from repro_torch.core.slab import FilterSlab, hot_d_from_mass
from repro_torch.graphs import generators as gen
from repro_torch.graphs.graph import GraphDB
from repro_torch.obs import Observability, device_annotation, use_obs
from repro_torch.serve.graph_engine import GraphQuery, GraphQueryEngine

N_DB, SEED = 300, 3
HOT_D = 16
STATS = ("verified_pairs", "lb_pruned", "lb_tightened")
PORT_BACKENDS = [dict(backend="torch", device="cpu"), dict(backend="numpy")]


def _same_db(a, b):
    assert len(a) == len(b)
    assert (a.n_vlabels, a.n_elabels) == (b.n_vlabels, b.n_elabels)
    for g, h in zip(a, b):
        assert g.n == h.n
        assert np.array_equal(g.vlabels, h.vlabels)
        assert np.array_equal(g.edges, h.edges)
        assert np.array_equal(g.elabels, h.elabels)


def _queries(db, n, edits, seed, make):
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(db), n)
    return [make(db[int(i)], edits, rng, db.n_vlabels, db.n_elabels)
            for i in idx]


@pytest.fixture(scope="module")
def dbs():
    jdb, db = jgen.aids_like_db(N_DB, seed=SEED), gen.aids_like_db(N_DB,
                                                                  seed=SEED)
    return jdb, db


@pytest.fixture(scope="module")
def indexes(dbs):
    return JFlat(dbs[0]), FlatMSQIndex(dbs[1])


@pytest.fixture(scope="module")
def queries(dbs):
    jq = _queries(dbs[0], 12, 2, 5, jgen.perturb_graph)
    pq = _queries(dbs[1], 12, 2, 5, gen.perturb_graph)
    return jq, pq


def test_generators_give_the_same_graphs(dbs, queries):
    _same_db(*dbs)
    _same_db(JGraphDB(queries[0]), GraphDB(queries[1]))
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(5):
        _same_db(JGraphDB([jgen.random_graph(ra, 9, 11, 4, 2)]),
                 GraphDB([gen.random_graph(rb, 9, 11, 4, 2)]))


def test_convert_and_load_carry_the_db_across(dbs, tmp_path):
    jdb = dbs[0]
    db = graphdb_from_arrays([g.n for g in jdb], [g.vlabels for g in jdb],
                             [g.edges for g in jdb], [g.elabels for g in jdb],
                             jdb.n_vlabels, jdb.n_elabels)
    _same_db(jdb, db)
    path = str(tmp_path / "db.npz")
    jdb.save(path)
    _same_db(jdb, GraphDB.load(path))


@pytest.mark.parametrize("layout,hot_d", [("dense", None), ("hot", HOT_D),
                                          ("packed", None)])
def test_filter_slab_equals_jax_package(indexes, layout, hot_d):
    j, p = indexes
    a = JSlab.build(j.db, j.enc, j.partition, layout=layout, hot_d=hot_d)
    b = FilterSlab.build(p.db, p.enc, p.partition, layout=layout, hot_d=hot_d)
    assert (a.U, a.hot_d, a.vmax) == (b.U, b.hot_d, b.vmax)
    assert b.hot_d < b.U or layout != "hot"
    fields = ["nv", "ne", "degseq", "vhist", "ehist", "region_i",
              "region_j", "bvlab", "bdeg", "behist"]
    if layout == "hot":
        fields += ["t_off", "t_ids", "t_cnt"]
    if layout == "packed":
        assert a.fd is None and b.fd is None
        for f in ("words", "sb", "widths"):
            assert np.array_equal(getattr(a.packed, f), getattr(b.packed, f))
        assert a.packed.n_entries == b.packed.n_entries == b.U
        assert np.array_equal(a.fd_dense_np(), b.fd_dense_np())
    else:
        fields.append("fd")
    for f in fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.size_bits() == b.size_bits()
    assert a.bits_per_graph() == b.bits_per_graph()


def test_packed_gather_equals_jax_package(indexes):
    """A bucket's gathered packed sub-slab, pad rows included: the same
    words / offsets / widths as the JAX package's, pad rows decode to
    zeros and stay out of every region, and the host C_D of a query
    equals the dense slab's."""
    j, p = indexes
    a = JSlab.build(j.db, j.enc, j.partition, layout="packed")
    b = FilterSlab.build(p.db, p.enc, p.partition, layout="packed")
    dense = FilterSlab.build(p.db, p.enc, p.partition, layout="dense")
    idx = np.arange(3, 200, 7)
    sa, sb_ = a.gather(idx, 40), b.gather(idx, 40)
    for f in ("words", "sb", "widths"):
        assert np.array_equal(getattr(sa.packed, f), getattr(sb_.packed, f))
    fd = sb_.fd_dense_np()
    assert np.array_equal(fd, sa.fd_dense_np())
    assert np.array_equal(fd[:len(idx)], dense.fd[idx])
    assert not fd[len(idx):].any()
    assert (sb_.region_i[len(idx):] == -(2 ** 20)).all()
    assert sb_.base_arrays().fd.shape == (40, 1)
    qfd = dense.fd[idx[0]].astype(np.int64)
    assert np.array_equal(sb_.cd_one(qfd),
                          dense.gather(idx, 40).cd_one(qfd))


def test_config_equals_jax_package():
    want, got = j_get_config(), get_config()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("mass", [0.5, 0.95])
def test_hot_mass_width_equals_jax_package(indexes, mass):
    j, p = indexes
    H = j_hot_d_from_mass(j.enc, mass)
    assert hot_d_from_mass(p.enc, mass) == H
    ev = p.filter_eval("numpy", slab="hot", hot_mass=mass)
    assert ev.slab.hot_d == H
    assert ev is p.filter_eval("numpy", slab="hot", hot_d=H)


def test_scalar_candidates_equal_jax_package(indexes, queries):
    j, p = indexes
    for jq, pq in zip(*queries):
        for tau in (1, 3):
            assert p.candidates(pq, tau) == j.candidates(jq, tau)


def _run_ref(j, jq, tau, layout, backend="numpy"):
    hot_d = HOT_D if layout == "hot" else None
    batch = j.batched_candidates(jq, [tau] * len(jq), backend=backend,
                                 slab=layout, hot_d=hot_d)
    eng = JEngine(j, backend=backend, slab_layout=layout, hot_d=hot_d)
    res = eng.submit([JQuery(g, tau) for g in jq])
    return batch, res, {k: eng.stats[k] for k in STATS}


@pytest.fixture(scope="module")
def ref_runs(indexes, queries):
    cache = {}

    def get(tau, layout, backend="numpy"):
        if (tau, layout, backend) not in cache:
            cache[tau, layout, backend] = _run_ref(
                indexes[0], queries[0], tau, layout, backend)
        return cache[tau, layout, backend]
    return get


def _check_same(batch, res, stats, want):
    wbatch, wres, wstats = want
    assert batch.ids == wbatch.ids
    for a, b in zip(batch.bounds, wbatch.bounds):
        assert np.array_equal(a, b)
    assert batch.lbs is not None
    for a, b in zip(batch.lbs, wbatch.lbs):
        assert np.array_equal(a, b)
    for r, w in zip(res, wres):
        assert r.candidates == w.candidates
        assert r.matches == w.matches
        assert r.n_filtered == w.n_filtered
    assert stats == wstats


@pytest.mark.parametrize("kw", PORT_BACKENDS, ids=["torch-cpu", "numpy"])
@pytest.mark.parametrize("layout", ["dense", "hot", "packed"])
@pytest.mark.parametrize("tau", [1, 3])
def test_range_queries_equal_jax_package(indexes, queries, ref_runs, tau,
                                         layout, kw):
    p = indexes[1]
    pq = queries[1]
    hot_d = HOT_D if layout == "hot" else None
    batch = p.batched_candidates(pq, [tau] * len(pq), slab=layout,
                                 hot_d=hot_d, **kw)
    eng = GraphQueryEngine(p, slab_layout=layout, hot_d=hot_d, **kw)
    res = eng.submit([GraphQuery(g, tau) for g in pq])
    want = ref_runs(tau, layout)
    _check_same(batch, res, {k: eng.stats[k] for k in STATS}, want)
    assert sum(len(c) for c in batch.ids) > 0
    if tau == 3:
        assert sum(len(r.matches) for r in res) > 0


@pytest.mark.parametrize("kw", PORT_BACKENDS, ids=["torch-cpu", "numpy"])
def test_packed_range_queries_equal_jax_backend(indexes, queries, ref_runs,
                                                kw):
    """The packed slab against the JAX package's ``jax`` backend, whose
    pass decodes the packed rows on its device (``unpack_rows_ref``)."""
    p = indexes[1]
    pq = queries[1]
    want = ref_runs(3, "packed", "jax")
    _check_same(*want[:2], want[2], ref_runs(3, "dense"))
    batch = p.batched_candidates(pq, [3] * len(pq), slab="packed", **kw)
    eng = GraphQueryEngine(p, slab_layout="packed", **kw)
    res = eng.submit([GraphQuery(g, 3) for g in pq])
    _check_same(batch, res, {k: eng.stats[k] for k in STATS}, want)


def test_packed_torch_pass_decodes_each_launch(indexes, queries):
    """The torch backend keeps the bucket's packed rows in the device
    cache (no dense F_D field) and its bounds equal the dense slab's."""
    p = indexes[1]
    pq = queries[1]
    taus = [3] * len(pq)
    got = p.batched_candidates(pq, taus, backend="torch", device="cpu",
                               slab="packed")
    want = p.batched_candidates(pq, taus, backend="torch", device="cpu")
    assert got.ids == want.ids
    for a, b in zip(got.bounds, want.bounds):
        assert np.array_equal(a, b)
    ev = p.filter_eval("torch", device="cpu", slab="packed")
    fields = set()
    for entry in ev.device_cache._entries.values():
        fields |= set(entry)
    assert "packed" in fields and "fd" not in fields


@pytest.fixture(scope="module")
def label_poor():
    # label-poor on purpose: the q-gram filter admits candidates whose GED
    # is far above tau, so the LB stage prunes and tightens here
    kw = dict(num_edges=12, density=0.5, n_vlabels=3, n_elabels=2, seed=3)
    jdb, db = jgen.graphgen_db(120, **kw), gen.graphgen_db(120, **kw)
    _same_db(jdb, db)
    jq = _queries(jdb, 6, 2, 11, jgen.perturb_graph)
    pq = _queries(db, 6, 2, 11, gen.perturb_graph)
    return JFlat(jdb), FlatMSQIndex(db), jq, pq


@pytest.mark.parametrize("kw", PORT_BACKENDS, ids=["torch-cpu", "numpy"])
def test_lb_stage_prunes_identically(label_poor, kw):
    j, p, jq, pq = label_poor
    want = _run_ref(j, jq, 4, "dense")
    assert want[2]["lb_pruned"] > 0
    batch = p.batched_candidates(pq, [4] * len(pq), **kw)
    eng = GraphQueryEngine(p, **kw)
    res = eng.submit([GraphQuery(g, 4) for g in pq])
    _check_same(batch, res, {k: eng.stats[k] for k in STATS}, want)


def test_topk_query_equals_jax_package(indexes, queries):
    j, p = indexes
    jq, pq = queries
    want = JEngine(j, backend="numpy").query_topk(jq[0], k=3, cap=4)
    got = GraphQueryEngine(p, backend="torch", device="cpu").query_topk(
        pq[0], k=3, cap=4)
    assert got.matches == want.matches
    assert got.candidates == want.candidates
    assert got.stats["topk_rounds"] == want.stats["topk_rounds"]


def test_buckets_and_evaluator_reuse(indexes, queries):
    j, p = indexes
    pq = queries[1]
    taus = [3] * len(pq)
    from repro.core.engine import bucket_queries as j_bucket_queries
    assert bucket_queries(p.partition, pq, taus) \
        == j_bucket_queries(j.partition, queries[0], taus)
    ev = p.filter_eval("torch", device="cpu")
    assert ev is p.filter_eval("torch", device="cpu")
    assert ev.device == torch.device("cpu")
    # a second batch reuses the gathered, device-resident bucket operands
    p.batched_candidates(pq, taus, backend="torch", device="cpu")
    hits = ev.device_cache.snapshot()["hits"]
    p.batched_candidates(pq, taus, backend="torch", device="cpu")
    assert ev.device_cache.snapshot()["hits"] > hits


def test_empty_batch_and_empty_region(indexes):
    from repro_torch.graphs.graph import Graph
    p = indexes[1]
    eng = GraphQueryEngine(p, backend="torch", device="cpu")
    assert eng.submit([]) == []
    giant = Graph(n=500, vlabels=np.zeros(500, np.int32),
                  edges=np.array([(i, i + 1) for i in range(499)], np.int64),
                  elabels=np.zeros(499, np.int32))
    res = eng.query(giant, 1)
    assert res.candidates == [] and res.matches == []
    assert res.n_filtered == len(p.db)


def test_spans_bracket_the_device_pass(indexes, queries):
    p = indexes[1]
    obs = Observability(spans=True)
    eng = GraphQueryEngine(p, backend="torch", device="cpu", obs=obs)
    eng.submit([GraphQuery(g, 2, verify=False) for g in queries[1][:3]])
    names = {s.name for s in obs.spans.spans()}
    assert {"bucket", "filter_bucket", "assign_lb", "filter"} <= names
    with use_obs(obs):
        with device_annotation("msq.test"):
            pass


def test_fault_hook_fires_at_the_device_points(indexes, queries):
    class Recorder:
        def __init__(self):
            self.points = []

        def fire(self, point, **ctx):
            self.points.append(point)

    p = indexes[1]
    rec = Recorder()
    eng = GraphQueryEngine(p, backend="torch", device="cpu", faults=rec)
    eng.submit([GraphQuery(g, 2) for g in queries[1][:4]])
    assert {"device.filter", "device.cache"} <= set(rec.points)
