"""The port's hybrid block decode (``repro_torch.kernels.bitunpack``) held
against the JAX package on the CPU.

The packers are copies and must give the JAX package's arrays exactly;
the plain PyTorch decodes (``ref.unpack_hybrid_ref``,
``ref.unpack_rows_ref``) and the host decode (``ops.unpack_rows_np``)
must equal the JAX package's ``unpack_hybrid_ref`` / ``unpack_rows_ref``
/ ``unpack_rows_np`` bit for bit (int32: tolerance zero), on values that
hit every width — 32 included, up to 2**32 - 1, which come back as
negative int32 — and on empty and all-zero blocks.  The JAX package's
Pallas decode does not run on the installed JAX, so it is not a
reference here.  The CUDA kernel is compared with the plain version on
the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitunpack import ops as jops
from repro.kernels.bitunpack import ref as jref
from repro_torch.kernels.bitunpack import kernel, ops, ref


def _values(case: str, rng) -> np.ndarray:
    """Flat value vectors; each 128-entry block picks its own width."""
    if case == "every_width":
        tops = [1, 3, 15, 255, 65535, 2 ** 32 - 1]
        return np.concatenate([rng.integers(0, t, 128, endpoint=True)
                               for t in tops] + [np.full(128, t)
                                                 for t in tops])
    if case == "width32_high":
        v = rng.integers(2 ** 31, 2 ** 32, 300, dtype=np.int64)
        v[::7] = 2 ** 32 - 1
        return v
    if case == "zeros_and_empty_blocks":
        v = np.zeros(5 * 128 + 17, np.int64)
        v[200] = 70000
        return v
    if case == "ragged_tail":
        return rng.integers(0, 1000, 1000)
    if case == "single":
        return np.asarray([5])
    raise ValueError(case)


CASES = ["every_width", "width32_high", "zeros_and_empty_blocks",
         "ragged_tail", "single"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _u32_as_i32(v: np.ndarray) -> np.ndarray:
    return np.asarray(v, np.int64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", CASES)
def test_flat_decode_equals_jax_ref(case):
    rng = np.random.default_rng(CASES.index(case))
    vals = _values(case, rng)
    words, sb, widths, n = ops.pack_hybrid(vals)
    jw, jsb, jwd, jn = jops.pack_hybrid(vals)
    for a, b in ((words, jw), (sb, jsb), (widths, jwd)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert n == jn == len(vals)
    want = np.asarray(jref.unpack_hybrid_ref(jnp.asarray(sb),
                                             jnp.asarray(widths),
                                             jnp.asarray(words)))
    got = ref.unpack_hybrid_ref(_t(sb), _t(widths), _t(words))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.reshape(-1)[:n].numpy(), _u32_as_i32(vals))
    flat = ops.unpack_hybrid(sb, widths, words, n, device="cpu")
    assert np.array_equal(flat.numpy(), _u32_as_i32(vals))
    if case == "every_width":
        assert set(widths.tolist()) == set(ops.WIDTHS)
    if case == "width32_high":
        assert (got.reshape(-1)[:n] < 0).all()


def _matrix(rng, B, U, top):
    """Sparse non-negative (B, U) counts, a few rows wide, some empty."""
    m = (rng.random((B, U)) < 0.1) * rng.integers(0, top, (B, U),
                                                  endpoint=True)
    m[::5] = 0
    if B > 3:
        m[3, :min(U, 40)] = top
    return m


ROW_SHAPES = [(1, 5, 3), (7, 130, 20), (16, 300, 2 ** 32 - 1),
              (9, 257, 70000), (40, 1851, 9)]


@pytest.mark.parametrize("B,U,top", ROW_SHAPES)
def test_row_decodes_equal_jax_package(B, U, top):
    rng = np.random.default_rng(B * 1000 + U)
    m = _matrix(rng, B, U, top)
    pk = ops.pack_hybrid_rows(m)
    jpk = jops.pack_hybrid_rows(m)
    for f in ("words", "sb", "widths"):
        a, b = getattr(pk, f), getattr(jpk, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert pk.n_entries == jpk.n_entries == U
    want = np.asarray(jref.unpack_rows_ref(jnp.asarray(pk.words),
                                           jnp.asarray(pk.sb),
                                           jnp.asarray(pk.widths)))
    got = ref.unpack_rows_ref(_t(pk.words), _t(pk.sb), _t(pk.widths))
    assert np.array_equal(got.numpy(), want)
    host = ops.unpack_rows_np(pk)
    assert np.array_equal(host, jops.unpack_rows_np(jpk))
    assert np.array_equal(host, _u32_as_i32(m).reshape(B, U))
    assert np.array_equal(got[:, :U].numpy(), host)
    assert not got[:, U:].any()
    assert ops.packed_rows_size_bits(pk) == jops.packed_rows_size_bits(jpk)


@pytest.mark.parametrize("B,U,top", ROW_SHAPES)
def test_flattened_rows_decode_as_the_rows(B, U, top):
    """The kernel's row form (row base computed from W) and the flat form
    (offsets rebased by ``flatten_packed_rows``) decode alike."""
    rng = np.random.default_rng(B + U)
    pk = ops.pack_hybrid_rows(_matrix(rng, B, U, top))
    words, sb, widths = ops.flatten_packed_rows(pk)
    jwords, jsb, jwidths = jops.flatten_packed_rows(pk)
    assert np.array_equal(words, jwords) and np.array_equal(sb, jsb)
    assert np.array_equal(widths, jwidths)
    flat = ref.bitunpack(_t(sb), _t(widths), _t(words))
    rows = ref.bitunpack(_t(pk.sb), _t(pk.widths), _t(pk.words))
    assert np.array_equal(flat.reshape(B, -1).numpy(), rows.numpy())


def test_pad_rows_decode_to_zeros_into_the_padded_block():
    """A gathered sub-slab's pad rows (zero words at width 2, offsets
    k*8) decode to zeros, and the row decode writes the U ladder's
    zero-padded width in one go."""
    rng = np.random.default_rng(4)
    m = _matrix(rng, 12, 300, 255)
    pk = ops.pack_hybrid_rows(m)
    KB, pad = pk.sb.shape[1], 4
    words = np.vstack([pk.words, np.zeros((pad, pk.words.shape[1]),
                                          np.int32)])
    sb = np.vstack([pk.sb, np.repeat((np.arange(KB) * 8)[None], pad, 0)
                    .astype(np.int32)])
    widths = np.vstack([pk.widths, np.full((pad, KB), 2, np.int32)])
    out = ops.unpack_rows_device(_t(words), _t(sb), _t(widths), 512)
    assert out.shape == (16, 512) and out.dtype == torch.int32
    assert np.array_equal(out[:12, :300].numpy(), m)
    assert not out[12:].any() and not out[:, 300:].any()
    want = np.asarray(jref.unpack_rows_ref(jnp.asarray(words),
                                           jnp.asarray(sb),
                                           jnp.asarray(widths)))
    assert np.array_equal(out[:, :KB * 128].numpy(), want)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(2)
    pk = ops.pack_hybrid_rows(_matrix(rng, 6, 200, 20))
    before = kernel.bitunpack_call.launches
    got = kernel.bitunpack_call(_t(pk.sb), _t(pk.widths), _t(pk.words), 256)
    want = ref.bitunpack(_t(pk.sb), _t(pk.widths), _t(pk.words), 256)
    assert kernel.bitunpack_call.launches == before
    assert torch.equal(got, want) and got.shape == (6, 256)


@pytest.mark.parametrize("case", CASES)
def test_packed_size_bits_equals_jax_package(case):
    vals = _values(case, np.random.default_rng(7))
    words, sb, widths, _ = ops.pack_hybrid(vals)
    assert ops.packed_size_bits(words, sb, widths) \
        == jops.packed_size_bits(words, sb, widths)


def test_packers_refuse_what_the_format_cannot_hold():
    with pytest.raises(ValueError):
        ops.pack_hybrid(np.asarray([3, -1]))
    with pytest.raises(ValueError):
        ops.pack_hybrid_rows(np.asarray([[2 ** 32]]))
    with pytest.raises(ValueError):
        ops.pack_hybrid_rows(np.asarray([[1, -2]]))
    with pytest.raises(ValueError):
        ops.pack_hybrid_rows(np.arange(4))
