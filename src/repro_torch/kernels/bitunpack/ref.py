"""Plain PyTorch version of the hybrid block decode — the oracle the CUDA
kernel is held against, and the body of the ``torch`` backend's packed
slab decode.

Entry e of block k sits at bit ``sb[k]*32 + e*w`` of the word stream,
MSB-first within its word, at the block's width w in {2, 4, 8, 16, 32};
w divides 32, so no entry straddles a word.  The arithmetic runs in
int64 so that width 32 needs no special case; a value >= 2**31 comes
back as the negative int32 of the same bits, as the reference's
``astype(int32)`` gives.
"""
from __future__ import annotations

from typing import Optional

import torch

BLOCK_ENTRIES = 128


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 of the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _decode(wvals: torch.Tensor, bit: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """Entries at absolute bit offsets ``bit`` of width ``w`` out of the
    words ``wvals`` that hold them (all int64, words as unsigned)."""
    shift = 32 - w - bit % 32
    mask = (torch.ones_like(w) << w) - 1
    return _as_int32((wvals >> shift) & mask)


def unpack_hybrid_ref(sb: torch.Tensor, widths: torch.Tensor,
                      words: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 128) int32 decode of the flat stream: ``sb`` holds
    absolute word offsets, ``words`` the whole stream (guard words
    included)."""
    e = torch.arange(BLOCK_ENTRIES, device=sb.device)[None, :]
    w = widths.long()[:, None]
    bit = sb.long()[:, None] * 32 + e * w
    wvals = words.long()[bit // 32] & 0xFFFFFFFF
    return _decode(wvals, bit, w)


def unpack_rows_ref(words: torch.Tensor, sb: torch.Tensor,
                    widths: torch.Tensor) -> torch.Tensor:
    """(B, KB*128) int32 decode of the rectangular row-wise slab:
    ``words`` (B, W), ``sb`` / ``widths`` (B, KB) with offsets *within
    the row*."""
    B, KB = sb.shape
    e = torch.arange(BLOCK_ENTRIES, device=sb.device)[None, None, :]
    w = widths.long()[:, :, None]
    bit = (sb.long()[:, :, None] * 32 + e * w).reshape(B, -1)
    w = w.expand(B, KB, BLOCK_ENTRIES).reshape(B, -1)
    wvals = torch.gather(words.long(), 1, bit // 32) & 0xFFFFFFFF
    return _decode(wvals, bit, w)


def bitunpack(sb: torch.Tensor, widths: torch.Tensor, words: torch.Tensor,
              out_cols: Optional[int] = None) -> torch.Tensor:
    """The contract of ``kernel.bitunpack_call`` on any device.

    Flat form (``sb`` 1-D): (n_blocks, 128).  Row form (``sb`` (B, KB),
    ``words`` (B, W)): (B, out_cols), the decoded KB*128 columns followed
    by zeros up to ``out_cols`` (default KB*128)."""
    if sb.dim() == 1:
        return unpack_hybrid_ref(sb, widths, words)
    out = unpack_rows_ref(words, sb, widths)
    if out_cols is not None and out_cols > out.shape[1]:
        out = torch.nn.functional.pad(out, (0, out_cols - out.shape[1]))
    return out
