"""Host packer and device decode for the hybrid block encoding.

Each block of 128 entries is stored at the narrowest power-of-two width
in {2, 4, 8, 16, 32} that holds its largest value (the paper's per-block
scheme choice, with fixed-width lanes in place of bit-serial codes).  A
block at width w takes 4*w whole words, so block offsets are word
offsets and no entry straddles a word.

Two packed forms share that coding:

* the flat stream (``pack_hybrid`` / ``unpack_hybrid``): one word array
  with absolute block offsets and ``MAX_WORDS`` trailing guard words;
* the rectangular row-wise slab (``pack_hybrid_rows`` / ``PackedRows``):
  one row of words per graph, offsets relative to the row, so bucket
  rows gather like any (B, X) array (the ``packed`` FilterSlab layout,
  DESIGN.md §11).  ``flatten_packed_rows`` rebases it onto the flat
  form; the kernel also decodes the row form directly
  (``unpack_rows_device``), straight into a zero-padded F_D block.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.bitunpack.ref import BLOCK_ENTRIES

WIDTHS = (2, 4, 8, 16, 32)
MAX_WORDS = BLOCK_ENTRIES * 32 // 32  # width=32 worst case: 128 words


def pack_hybrid(values: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack int values into the block-width hybrid format.

    Returns (words int32, sb int32, widths int32, n_valid) where the last
    block is zero-padded to 128 entries and ``words`` carries MAX_WORDS
    trailing guard words.
    """
    values = np.asarray(values, np.int64)
    if values.size and values.min() < 0:
        raise ValueError("values must be non-negative")
    n = int(values.size)
    n_blocks = max((n + BLOCK_ENTRIES - 1) // BLOCK_ENTRIES, 1)
    padded = np.zeros(n_blocks * BLOCK_ENTRIES, np.int64)
    padded[:n] = values
    sb = np.zeros(n_blocks, np.int32)
    widths = np.zeros(n_blocks, np.int32)
    words: list[int] = []
    for k in range(n_blocks):
        blk = padded[k * BLOCK_ENTRIES:(k + 1) * BLOCK_ENTRIES]
        need = max(int(blk.max()).bit_length(), 1)
        w = next(x for x in WIDTHS if x >= need)
        widths[k] = w
        sb[k] = len(words)
        per = 32 // w
        blk_u = blk.astype(np.uint64)
        for i in range(BLOCK_ENTRIES // per):
            word = 0
            for e in range(per):
                word = (word << w) | int(blk_u[i * per + e])
            words.append(word)
    words_arr = np.zeros(len(words) + MAX_WORDS, np.uint32)
    words_arr[:len(words)] = np.asarray(words, np.uint32)
    return words_arr.view(np.int32), sb, widths, n


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(
        torch.device("cuda" if device is None else device))


def unpack_hybrid(sb, widths, words, n_valid: Optional[int] = None, *,
                  device=None) -> torch.Tensor:
    """Decode the flat stream to (n_valid,) int32 (kernel + trim).

    Tensors stay where they lie; numpy arrays go to ``device``, the CUDA
    device unless the caller names another.  On a CUDA device the decode
    is the kernel (``kernel.bitunpack_call``), on the CPU its plain
    version."""
    from repro_torch.kernels.bitunpack.kernel import bitunpack_call
    out = bitunpack_call(_tensor(sb, device), _tensor(widths, device),
                         _tensor(words, device))
    flat = out.reshape(-1)
    return flat if n_valid is None else flat[:n_valid]


def unpack_rows_device(words: torch.Tensor, sb: torch.Tensor,
                       widths: torch.Tensor, out_cols: int, *,
                       fn: Optional[Callable] = None) -> torch.Tensor:
    """One bucket's packed rows decoded on their device into the (B,
    out_cols) int32 F_D block the filter kernel reads: the KB*128 decoded
    columns, then zeros up to ``out_cols`` (the U ladder's width), so the
    block needs no second copy to reach the filter's padded shape.

    ``fn`` runs the decode: the kernel wrapper ``kernel.bitunpack_call``
    by default, ``ref.bitunpack`` for the plain version."""
    if fn is None:
        from repro_torch.kernels.bitunpack.kernel import bitunpack_call
        fn = bitunpack_call
    return fn(sb, widths, words, out_cols)


def packed_size_bits(words: np.ndarray, sb: np.ndarray,
                     widths: np.ndarray) -> int:
    """Index footprint of the packed representation (excl. guard words)."""
    payload = int(sb[-1]) * 32 if len(sb) else 0
    # last block payload:
    if len(sb):
        payload += BLOCK_ENTRIES // (32 // int(widths[-1])) * 32
    sb_bits = len(sb) * 32
    w_bits = len(widths) * 3  # 5 widths -> 3 bits each
    return payload + sb_bits + w_bits


# --------------------------------------------------------------------------
# rectangular row-wise packed slab (the FilterSlab 'packed' layout)
# --------------------------------------------------------------------------

class PackedRows(NamedTuple):
    """Row-wise hybrid-packed matrix: row r of the original (B, U) int
    matrix lives in ``words[r]`` as ``KB = ceil(U/128)`` width-coded blocks.

    words:     (B, W) int32 — per-row block payloads concatenated,
               zero-padded to W = max row payload words
    sb:        (B, KB) int32 — word offset of block k *within its row*
    widths:    (B, KB) int32 — bit width per block (one of WIDTHS)
    n_entries: valid entries per row (U); entries beyond are pad zeros
    """

    words: np.ndarray
    sb: np.ndarray
    widths: np.ndarray
    n_entries: int


def _block_widths(mx: np.ndarray) -> np.ndarray:
    """Narrowest width in WIDTHS holding values <= mx (vectorised)."""
    w = np.full(mx.shape, WIDTHS[0], np.int32)
    for wide in WIDTHS[1:]:
        w[mx >= (1 << (wide // 2))] = wide
    if (mx >= (1 << 32)).any():
        raise ValueError("values do not fit in 32 bits")
    return w


def pack_hybrid_rows(mat: np.ndarray) -> PackedRows:
    """Pack a (B, U) non-negative int matrix row-by-row.

    Unlike ``pack_hybrid`` the result is rectangular, so rows gather like
    a dense matrix while the payload keeps the per-block hybrid width
    coding.  Decode with ``unpack_rows_np`` (host), ``ref.unpack_rows_ref``
    (torch) or the kernel (``unpack_rows_device``).
    """
    mat = np.asarray(mat, np.int64)
    if mat.ndim != 2:
        raise ValueError(f"expected a (B, U) matrix, got shape {mat.shape}")
    if mat.size and mat.min() < 0:
        raise ValueError("values must be non-negative")
    B, U = mat.shape
    KB = max((U + BLOCK_ENTRIES - 1) // BLOCK_ENTRIES, 1)
    blk = np.zeros((B, KB * BLOCK_ENTRIES), np.int64)
    blk[:, :U] = mat
    blk = blk.reshape(B, KB, BLOCK_ENTRIES)
    widths = _block_widths(blk.max(axis=2)) if B else np.zeros((0, KB),
                                                               np.int32)
    # words per block = 128 * w / 32 = 4w; sb = exclusive prefix per row
    wpb = 4 * widths
    sb = np.zeros((B, KB), np.int32)
    if KB > 1:
        sb[:, 1:] = np.cumsum(wpb[:, :-1], axis=1)
    W = int((sb[:, -1] + wpb[:, -1]).max()) if B else 4 * WIDTHS[0] * KB
    words = np.zeros((B, W), np.uint32)
    for w in WIDTHS:
        rsel, ksel = np.nonzero(widths == w)
        if not len(rsel):
            continue
        per = 32 // w
        ent = blk[rsel, ksel].reshape(-1, 4 * w, per).astype(np.uint64)
        shifts = ((per - 1 - np.arange(per)) * w).astype(np.uint64)
        payload = (ent << shifts[None, None, :]).sum(axis=2).astype(np.uint32)
        # scatter each block's 4w words into its row at sb
        col = sb[rsel, ksel][:, None] + np.arange(4 * w)[None, :]
        words[rsel[:, None], col] = payload
    return PackedRows(words=words.view(np.int32), sb=sb, widths=widths,
                      n_entries=U)


def unpack_rows_np(pk: PackedRows) -> np.ndarray:
    """Host decode of ``PackedRows`` to the dense (B, U) int32 matrix."""
    B, KB = pk.sb.shape
    e = np.arange(BLOCK_ENTRIES, dtype=np.int64)[None, None, :]
    w = pk.widths[:, :, None].astype(np.int64)
    bit = pk.sb[:, :, None].astype(np.int64) * 32 + e * w
    rows = np.arange(B)[:, None, None]
    wvals = pk.words.view(np.uint32)[rows, bit // 32].astype(np.uint64)
    shift = (32 - w - bit % 32).astype(np.uint64)
    mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
    out = ((wvals >> shift) & mask).astype(np.int32)
    return out.reshape(B, KB * BLOCK_ENTRIES)[:, :pk.n_entries]


def flatten_packed_rows(pk: PackedRows
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rebase row-relative offsets to the flat stream.

    Returns (words, sb, widths) for ``unpack_hybrid``: words raveled with
    MAX_WORDS trailing guard words, sb made absolute (row*W + local).
    """
    B, W = pk.words.shape
    if B * W + MAX_WORDS > np.iinfo(np.int32).max:
        # flat offsets are int32; beyond this the slab must be split
        # into sub-buckets before flattening
        raise ValueError(f"packed slab too large to flatten: {B} rows x "
                         f"{W} words overflows int32 word offsets")
    words = np.concatenate([pk.words.reshape(-1),
                            np.zeros(MAX_WORDS, np.int32)])
    sb = (np.arange(B, dtype=np.int64)[:, None] * W
          + pk.sb).astype(np.int32).reshape(-1)
    return words, sb, pk.widths.reshape(-1).astype(np.int32)


def packed_rows_size_bits(pk: PackedRows) -> dict:
    """Serving-resident footprint of the rectangular packed slab — counted
    at the arrays' actual int32 residency (widths could pack into 3 bits
    each, but that is not how they sit in memory) — plus the ragged
    payload lower bound (what a length-exact stream would take)."""
    B, W = pk.words.shape
    KB = pk.sb.shape[1]
    words_bits = B * W * 32
    sb_bits = B * KB * 32
    widths_bits = B * KB * 32
    ragged_bits = int((4 * pk.widths.astype(np.int64)).sum()) * 32
    return {"words": words_bits, "sb": sb_bits, "widths": widths_bits,
            "total": words_bits + sb_bits + widths_bits,
            "ragged_payload": ragged_bits}
