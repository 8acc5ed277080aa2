"""The port's fused q-gram filter cascade (``repro_torch.kernels.qgram_filter``)
held against the JAX package on the CPU.

The plain PyTorch version (``ref.fused_batched_bounds``) must equal the
JAX package's oracle (``fused_batched_bounds_ref``) and its Pallas kernel
in interpret mode, bit for bit (every value is an int32: tolerance zero),
on ragged shapes with a non-zero C_D seed and with region geometry whose
floor-divided numerators and region coordinates go negative.  The
single-query cascade (``ref.fused_filter_bounds``,
``ops.fused_filter_bounds``) is held the same way against
``fused_filter_bounds_ref`` and the single-query Pallas kernel, with and
without its aux column-4 C_D seed.  The CUDA kernels themselves are
compared with the plain versions on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qgram_filter import ops as jops
from repro.kernels.qgram_filter.ref import (fused_batched_bounds_ref,
                                            fused_filter_bounds_ref)
from repro_torch.kernels.qgram_filter import kernel, ops, ref


def _case(rng, Q, B, U, NV=7, NE=3, VM=11):
    """Random (Q, B) operands; half the queries sit far from the region
    origin so their region numerators are negative, and region
    coordinates range over negative values too."""
    fd = rng.integers(0, 4, (B, U))
    vh = rng.integers(0, 5, (B, NV))
    eh = rng.integers(0, 5, (B, NE))
    ds = -np.sort(-rng.integers(0, 6, (B, VM)), axis=1)
    aux = np.concatenate([rng.integers(1, 30, (B, 2)),
                          rng.integers(-9, 5, (B, 2))], 1)
    cdt = rng.integers(0, 4, (Q, B))
    x0y0 = np.where(rng.random((Q, 1)) < 0.5, 25, 60) \
        + rng.integers(-3, 4, (Q, 2))
    sc = np.concatenate([rng.integers(1, 30, (Q, 2)),
                         rng.integers(0, 5, (Q, 1)), x0y0,
                         rng.integers(1, 6, (Q, 1))], 1)
    qfd = rng.integers(0, 4, (Q, U))
    qvh = rng.integers(0, 5, (Q, NV))
    qeh = rng.integers(0, 5, (Q, NE))
    qsig = -np.sort(-rng.integers(0, 6, (Q, VM)), axis=1)
    # self-consistent queries (|V|, |E| are their label counts), and every
    # 5th graph a copy of one placed at its region corner: those pass
    sc[:, 0], sc[:, 1] = qvh.sum(1), qeh.sum(1)
    s = sc.astype(np.int64)
    i1 = (s[:, 1] - s[:, 2] + s[:, 0] - (s[:, 3] + s[:, 4])) // s[:, 5]
    j1 = (s[:, 1] - s[:, 2] - s[:, 0] - (s[:, 4] - s[:, 3])) // s[:, 5]
    for b in range(0, B, 5):
        r = (b // 5) % Q
        fd[b], vh[b], eh[b], ds[b] = qfd[r], qvh[r], qeh[r], qsig[r]
        aux[b] = (sc[r, 0], sc[r, 1], i1[r], j1[r])
    return tuple(np.ascontiguousarray(x, np.int32) for x in
                 (sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig, aux, cdt))


def _jax_ref(case):
    b, m = fused_batched_bounds_ref(*[jnp.asarray(x) for x in case])
    return np.asarray(b), np.asarray(m)


def _torch(case):
    return [torch.from_numpy(x) for x in case]


def _region_numerators(case):
    sc = case[0].astype(np.int64)
    q_nv, q_ne, tau, x0, y0 = sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3], sc[:, 4]
    return np.stack([q_ne - tau + q_nv - (x0 + y0),
                     q_ne - tau - q_nv - (y0 - x0)])


SHAPES = [
    (1, 7, 33),        # everything ragged and tiny
    (5, 130, 260),     # Q/B/U all off the ladders
    (8, 64, 128),      # exactly on the ladders
    (13, 97, 515),     # ragged against every ladder step
]


@pytest.mark.parametrize("Q,B,U", SHAPES)
def test_ref_equals_jax_ref(Q, B, U):
    rng = np.random.default_rng(Q * 1000 + B)
    case = _case(rng, Q, B, U)
    assert (_region_numerators(case) < 0).any()
    assert (case[9][:, 2:] < 0).any()
    want_b, want_m = _jax_ref(case)
    got_b, got_m = ref.fused_batched_bounds(*_torch(case))
    assert got_b.dtype == torch.int32 and got_m.dtype == torch.int32
    assert np.array_equal(got_b.numpy(), want_b)
    assert np.array_equal(got_m.numpy(), want_m)
    assert 0 < want_m.sum() < want_m.size or Q * B < 64


@pytest.mark.parametrize("Q,B,U", SHAPES[:3])
def test_padded_ref_equals_pallas_interpret(Q, B, U):
    """The port's padding + plain version against the JAX package's
    padded Pallas kernel run in interpret mode, as its own tests run it."""
    rng = np.random.default_rng(Q * 7 + U)
    case = _case(rng, Q, B, U)
    want_b, want_m = jops.fused_filter_bounds_batched(
        *[jnp.asarray(x) for x in case], interpret=True)
    got_b, got_m = ops.fused_filter_bounds_batched(
        *_torch(case), fn=ref.fused_batched_bounds)
    assert got_b.shape == (Q, B)
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


def test_no_cdt_means_zeros():
    rng = np.random.default_rng(3)
    case = _case(rng, 4, 33, 140)
    zero = list(case)
    zero[-1] = np.zeros_like(case[-1])
    want_b, want_m = _jax_ref(tuple(zero))
    got_b, got_m = ops.fused_filter_bounds_batched(*_torch(case[:-1]), None)
    assert np.array_equal(got_b.numpy(), want_b)
    assert np.array_equal(got_m.numpy(), want_m)


def test_shape_bucket_matches_jax_package():
    for base, cap in ((jops.Q_BASE, jops.Q_CAP), (jops.B_BASE, jops.B_CAP),
                      (jops.U_BASE, jops.U_CAP)):
        for n in list(range(1, 130)) + [511, 512, 513, 1851, 10000, 12345]:
            assert ops.shape_bucket(n, base, cap) \
                == jops.shape_bucket(n, base, cap), (n, base, cap)
    assert (ops.Q_BASE, ops.Q_CAP, ops.B_BASE, ops.B_CAP, ops.U_BASE,
            ops.U_CAP) == (jops.Q_BASE, jops.Q_CAP, jops.B_BASE, jops.B_CAP,
                           jops.U_BASE, jops.U_CAP)


def test_pad_batched_contract():
    """Q pads by repeating the last scalar row, B with impossible graphs
    (all four aux columns at -2**20), U with zero counts; ``cdt=None``
    stays None (read as zeros)."""
    rng = np.random.default_rng(11)
    case = _torch(_case(rng, 3, 37, 130))
    sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig, aux, cdt = \
        ops.pad_batched(*case)
    assert sc.shape == (8, 6) and fd.shape == (64, 256)
    assert qfd.shape == (8, 256) and aux.shape == (64, 4)
    assert cdt.shape == (8, 64)
    assert torch.equal(sc[3:], case[0][-1:].expand(5, -1))
    assert bool((aux[37:] == ops.IMPOSSIBLE).all())
    assert int(fd[:, 130:].abs().sum()) == 0 and int(fd[37:].abs().sum()) == 0
    assert ops.pad_batched(*case[:-1], None)[-1] is None
    b, m = ref.fused_batched_bounds(sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig,
                                    aux, cdt)
    assert int(m[:, 37:].sum()) == 0          # pad graphs never pass


def test_upload_fd_pads_columns_to_the_ladder():
    fd = np.arange(5 * 130, dtype=np.int32).reshape(5, 130)
    up = ops.upload_fd(fd, torch.device("cpu"))
    assert up.shape == (5, 256) and up.dtype == torch.int32
    assert np.array_equal(up[:, :130].numpy(), fd)
    assert int(up[:, 130:].abs().sum()) == 0


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(5)
    args = ops.pad_batched(*_torch(_case(rng, 2, 20, 40)))
    before = kernel.fused_batched_call.launches
    got = kernel.fused_batched_call(*args)
    want = ref.fused_batched_bounds(*args)
    assert kernel.fused_batched_call.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------------------
# the single-query cascade (kernel 4): C_D seeded from aux column 4
# --------------------------------------------------------------------------

def _single_case(rng, B, U, seeded):
    """One query's operands from a batched case; aux gains column 4, the
    C_D seed (zeros when not ``seeded``).  The query is chosen so its
    region numerators go negative."""
    case = _case(rng, 4, B, U)
    r = int(np.argmin(_region_numerators(case).min(0)))
    sc, fd, qfd, vh, qvh, eh, qeh, ds, qsig, aux, _ = case
    seed = rng.integers(0, 4, (B, 1)) if seeded else np.zeros((B, 1))
    aux5 = np.concatenate([aux, seed], 1)
    return tuple(np.ascontiguousarray(x, np.int32) for x in
                 (sc[r], fd, qfd[r], vh, qvh[r], eh, qeh[r], ds, qsig[r],
                  aux5))


SINGLE_SHAPES = [(7, 33), (64, 256), (130, 700)]


@pytest.mark.parametrize("seeded", [True, False], ids=["seed", "no-seed"])
@pytest.mark.parametrize("B,U", SINGLE_SHAPES)
def test_single_query_equals_pallas_interpret(B, U, seeded):
    rng = np.random.default_rng(B * 3 + U + seeded)
    case = _single_case(rng, B, U, seeded)
    assert (_region_numerators((case[0][None],)) < 0).any()
    want_b, want_m = jops.fused_filter_bounds(
        *[jnp.asarray(x) for x in case], interpret=True)
    got_b, got_m = ops.fused_filter_bounds(*_torch(case),
                                           fn=ref.fused_filter_bounds)
    assert got_b.shape == (B,) and got_b.dtype == torch.int32
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    assert 0 < int(got_m.sum()) < B
    # the wrapper on CPU tensors is the plain version, with no launch
    before = kernel.fused_filter_call.launches
    kb, km = ops.fused_filter_bounds(*_torch(case))
    assert kernel.fused_filter_call.launches == before
    assert torch.equal(kb, got_b) and torch.equal(km, got_m)


@pytest.mark.parametrize("B,U", SINGLE_SHAPES)
def test_single_query_ref_equals_jax_ref(B, U):
    rng = np.random.default_rng(B + U)
    case = _single_case(rng, B, U, True)
    want_b, want_m = fused_filter_bounds_ref(*[jnp.asarray(x) for x in case])
    got_b, got_m = ref.fused_filter_bounds(*_torch(case))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


def test_single_query_seed_moves_the_degree_qgram_bound():
    """The seed is added to C_D: a negative seed raises the degree-q-gram
    bound until it binds, so bounds with and without it differ."""
    rng = np.random.default_rng(21)
    case = list(_single_case(rng, 64, 128, False))
    plain_b, _ = ref.fused_filter_bounds(*_torch(case))
    case[9] = case[9].copy()
    case[9][:, 4] = -1000
    seeded_b, _ = ref.fused_filter_bounds(*_torch(case))
    assert (seeded_b >= plain_b).all() and (seeded_b > plain_b).any()
    want_b, _ = fused_filter_bounds_ref(*[jnp.asarray(x) for x in case])
    assert np.array_equal(seeded_b.numpy(), np.asarray(want_b))
