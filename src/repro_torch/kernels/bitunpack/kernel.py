"""Launch of the hybrid block decode kernel (``csrc/bitunpack.cu``).

``bitunpack_call`` takes the flat stream (``sb``, ``widths`` 1-D, word
offsets absolute) or the row-wise slab (``sb``, ``widths`` (B, KB),
``words`` (B, W), offsets within the row).  Tensors on the CPU go to the
plain version (``ref.bitunpack``); tensors on a CUDA device launch the
kernel or raise — there is no fallback from the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._lib import LIBRARY, check_operands
from repro_torch.kernels.bitunpack import ref

BLOCK_ENTRIES = ref.BLOCK_ENTRIES


def bitunpack_call(sb, widths, words, out_cols: Optional[int] = None):
    """Flat form: (n_blocks, 128) int32.  Row form: (B, out_cols) int32,
    the KB*128 decoded columns then zeros (``out_cols`` defaults to
    KB*128 and must be a multiple of 128); the contract of
    ``ref.bitunpack``."""
    if sb.device.type == "cpu":
        return ref.bitunpack(sb, widths, words, out_cols)
    check_operands("bitunpack", sb=sb, widths=widths, words=words)
    if sb.dim() == 1:
        n_rows, kb, row_words = sb.shape[0], 1, 0
        if out_cols not in (None, BLOCK_ENTRIES) or words.dim() != 1:
            raise ValueError("bitunpack: the flat form decodes (n_blocks, "
                             "128) from a 1-D word stream")
        out_cols = BLOCK_ENTRIES
    else:
        (n_rows, kb), row_words = sb.shape, words.shape[-1]
        if words.dim() != 2 or words.shape[0] != n_rows:
            raise ValueError(f"bitunpack: words has shape "
                             f"{tuple(words.shape)}, expected ({n_rows}, W)")
        out_cols = kb * BLOCK_ENTRIES if out_cols is None else int(out_cols)
    if tuple(widths.shape) != tuple(sb.shape):
        raise ValueError(f"bitunpack: widths has shape "
                         f"{tuple(widths.shape)}, sb {tuple(sb.shape)}")
    if n_rows == 0 or out_cols % BLOCK_ENTRIES or \
            out_cols < kb * BLOCK_ENTRIES:
        raise ValueError(f"bitunpack: needs rows > 0 and out_cols a "
                         f"multiple of 128 >= {kb * BLOCK_ENTRIES}, got "
                         f"rows={n_rows} out_cols={out_cols}")
    out = torch.empty((n_rows, out_cols), dtype=torch.int32,
                      device=sb.device)
    fn = LIBRARY.function("repro_bitunpack", 4, 4)
    err = fn(sb.data_ptr(), widths.data_ptr(), words.data_ptr(),
             out.data_ptr(), n_rows, kb, row_words, out_cols,
             torch.cuda.current_stream(sb.device).cuda_stream)
    if err:
        raise RuntimeError(f"bitunpack launch failed: CUDA error {err}")
    bitunpack_call.launches += 1
    return out


bitunpack_call.launches = 0     # kernel launches (CPU calls excluded)
