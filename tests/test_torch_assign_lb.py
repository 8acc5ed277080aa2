"""The port's batched assignment lower bound (``repro_torch.kernels.assign_lb``)
held against the JAX package on the CPU.

The plain PyTorch version (``ref.batched_assign_lb``) and the port's
numpy oracle (``ops.assign_lb_np``) must equal the JAX package's
``assign_lb_np`` and its Pallas kernel in interpret mode, bit for bit, on
ragged (Q, N, VMq, VM) blocks that include pad vertices (label -1,
degree 0, zero histograms) and pad graphs (no vertices).  The CUDA kernel
is compared with the plain version on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.assign_lb import ops as jops
from repro.kernels.assign_lb.ref import batched_assign_lb_ref
from repro.kernels.qgram_filter.ops import shape_bucket
from repro_torch.kernels.assign_lb import kernel, ops, ref


def _case(rng, Q, N, vmq_raw, vm_raw):
    """Ragged branch-feature blocks padded as the engine pads them: the
    query side by ``pad_query_block``, the db side with the slab gather's
    fills (label -1 / degree 0 / zero histograms, vertex count 0)."""

    def feats(counts, vm):
        v = np.full((len(counts), vm), -1, np.int32)
        d = np.zeros((len(counts), vm), np.int32)
        eh = np.zeros((len(counts), vm, 3), np.int32)
        for r, c in enumerate(counts):
            v[r, :c] = rng.integers(0, 5, c)
            eh[r, :c] = rng.integers(0, 3, (c, 3))
            d[r, :c] = eh[r, :c].sum(1)
        return v, d, eh

    qn = rng.integers(1, vmq_raw + 1, Q).astype(np.int32)
    dn = rng.integers(1, vm_raw + 1, N).astype(np.int32)
    qv, qd, qeh = feats(qn, vmq_raw)
    dv, dd, deh = feats(dn, vm_raw)
    qv, qd, qeh, qn = ops.pad_query_block(qv, qd, qeh, qn)
    npad = shape_bucket(N, ops.N_BASE, ops.N_CAP)
    vmp = shape_bucket(vm_raw, ops.VM_BASE, ops.VM_CAP)
    pr = npad - N
    dv = np.pad(dv, [(0, pr), (0, vmp - vm_raw)], constant_values=-1)
    dd = np.pad(dd, [(0, pr), (0, vmp - vm_raw)])
    deh = np.pad(deh, [(0, pr), (0, vmp - vm_raw), (0, 0)])
    dn = np.pad(dn, (0, pr))
    return qv, qd, qeh, qn, dv, dd, deh, dn


SHAPES = [
    (1, 7, 5, 9),       # everything ragged and tiny
    (5, 130, 11, 17),   # every axis off its bucket
    (8, 64, 8, 16),     # exactly bucket-aligned
    (13, 97, 30, 40),   # ragged against the default tiles
]


@pytest.mark.parametrize("Q,N,VMq,VM", SHAPES)
def test_ref_and_np_equal_jax_package(Q, N, VMq, VM):
    rng = np.random.default_rng(Q * 1000 + N)
    case = _case(rng, Q, N, VMq, VM)
    want = jops.assign_lb_np(*case)
    got = ref.batched_assign_lb(*[torch.from_numpy(x) for x in case])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.assign_lb_np(*case), want)
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("Q,N,VMq,VM", SHAPES[:3])
def test_ref_equals_pallas_interpret_and_jax_ref(Q, N, VMq, VM):
    rng = np.random.default_rng(Q * 31 + VM)
    case = _case(rng, Q, N, VMq, VM)
    pallas = np.asarray(jops.assign_lb_bounds_batched(
        *case, qb=min(8, case[0].shape[0]), bb=min(128, case[4].shape[0]),
        interpret=True))
    jref = np.asarray(batched_assign_lb_ref(*[jnp.asarray(x) for x in case]))
    got = ref.batched_assign_lb(*[torch.from_numpy(x) for x in case]).numpy()
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, jref)


@pytest.mark.parametrize("Q,VMq", [(1, 1), (3, 9), (9, 40), (70, 130)])
def test_pad_query_block_matches_jax_package(Q, VMq):
    rng = np.random.default_rng(Q + VMq)
    qv = rng.integers(0, 6, (Q, VMq))
    qd = rng.integers(0, 4, (Q, VMq))
    qeh = rng.integers(0, 3, (Q, VMq, 3))
    qn = rng.integers(1, VMq + 1, Q)
    for a, b in zip(ops.pad_query_block(qv, qd, qeh, qn),
                    jops.pad_query_block(qv, qd, qeh, qn)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_hungarian_lb_pair_matches_jax_package():
    pytest.importorskip("scipy")
    rng = np.random.default_rng(4)
    for _ in range(6):
        n1, n2 = (int(x) for x in rng.integers(0, 7, 2))
        q = (rng.integers(0, 3, n1), rng.integers(0, 4, n1),
             rng.integers(0, 2, (n1, 3)))
        d = (rng.integers(0, 3, n2), rng.integers(0, 4, n2),
             rng.integers(0, 2, (n2, 3)))
        assert ops.hungarian_lb_pair(*q, *d) == jops.hungarian_lb_pair(*q, *d)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(2)
    case = [torch.from_numpy(x) for x in _case(rng, 3, 20, 6, 9)]
    before = kernel.assign_lb_call.launches
    got = kernel.assign_lb_call(*case)
    assert kernel.assign_lb_call.launches == before
    assert torch.equal(got, ref.batched_assign_lb(*case))
