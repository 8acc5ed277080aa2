"""The port's rank dictionary (``repro_torch.kernels.rank_popcount``) held
against the JAX package on the CPU.

The block popcounts of the port (its kernel wrapper, which runs the plain
version on CPU tensors, and ``ref.block_popcounts_ref``) must equal the
JAX package's Pallas kernel in interpret mode and its oracle; the
dictionary and ``rank1_query`` must equal the JAX package's and the
bit-by-bit oracles, exactly (int32: tolerance zero).  The CUDA kernel is
compared with the plain version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.succinct import BitVector
from repro.kernels.rank_popcount import kernel as jkernel
from repro.kernels.rank_popcount import ops as jops
from repro.kernels.rank_popcount import ref as jref
from repro_torch.kernels.rank_popcount import kernel, ops, ref


def _bits(case: str, n: int, rng) -> np.ndarray:
    if case == "random":
        return rng.integers(0, 2, n)
    if case == "sparse":
        return (rng.random(n) < 0.02).astype(np.int64)
    if case == "ones":
        return np.ones(n, np.int64)
    if case == "zeros":
        return np.zeros(n, np.int64)
    raise ValueError(case)


CASES = [("random", 1), ("random", 300), ("random", 8192),
         ("random", 30000), ("sparse", 20000), ("ones", 16384),
         ("zeros", 777)]


@pytest.mark.parametrize("case,n", CASES)
def test_block_popcounts_equal_jax_kernel(case, n):
    rng = np.random.default_rng(n)
    words = ops.pack_bits_u32(_bits(case, n, rng))
    assert np.array_equal(words, jops.pack_bits_u32(_bits(case, n,
                          np.random.default_rng(n))))
    w32 = words.view(np.int32)
    want = np.asarray(jkernel.block_popcounts(jnp.asarray(w32),
                                              interpret=True))
    assert np.array_equal(want,
                          np.asarray(jref.block_popcounts_ref(
                              jnp.asarray(w32))))
    before = kernel.block_popcounts.launches
    got = kernel.block_popcounts(torch.from_numpy(w32))
    assert kernel.block_popcounts.launches == before     # CPU: no launch
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.block_popcounts_ref(
        torch.from_numpy(w32)).numpy(), want)


@pytest.mark.parametrize("case,n", CASES)
def test_rank_dictionary_and_queries_equal_jax_package(case, n):
    rng = np.random.default_rng(n + 1)
    bits = _bits(case, n, rng)
    words, cum = ops.build_rank_dictionary(bits, device="cpu")
    jwords, jcum = jops.build_rank_dictionary(bits, interpret=True)
    assert np.array_equal(words.numpy(), np.asarray(jwords))
    assert np.array_equal(cum.numpy(), np.asarray(jcum))
    idx = np.concatenate([rng.integers(0, n + 1, 48), [0, n]])
    idx_t = torch.from_numpy(idx)
    got = ops.rank1_query(words, cum, idx_t)
    want = np.asarray(jops.rank1_query(jwords, jcum,
                                       jnp.asarray(idx.astype(np.int32))))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.rank1_query_ref(words, idx_t).numpy(), want)
    bv = BitVector(bits.astype(np.uint8))
    assert got.tolist() == [bv.rank1(int(i)) for i in idx]


def test_rank_at_the_end_of_a_full_block():
    """n bits exactly fill the words: rank1(n) names the word past the
    last one, whose head is empty."""
    bits = np.ones(8192, np.int64)
    words, cum = ops.build_rank_dictionary(bits, device="cpu")
    assert len(words) == 256
    got = ops.rank1_query(words, cum, torch.tensor([8191, 8192]))
    assert got.tolist() == [8191, 8192]


def test_popcounts_equal_jax_popcount():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 2000),
                        [0, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    want = np.asarray(jkernel.popcount_u32(jnp.asarray(x)))
    assert np.array_equal(ops.popcount_u32(torch.from_numpy(x)).numpy(), want)
    assert np.array_equal(ref.popcount_u32_ref(torch.from_numpy(x)).numpy(),
                          want)


def test_block_popcounts_refuse_a_ragged_block():
    with pytest.raises(ValueError):
        ref.block_popcounts_ref(torch.zeros(100, dtype=torch.int32))
