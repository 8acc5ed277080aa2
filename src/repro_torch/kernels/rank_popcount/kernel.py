"""Launch of the rank-dictionary block popcount kernel
(``csrc/rank_popcount.cu``).

Tensors on the CPU go to the plain version (``ref.block_popcounts_ref``);
tensors on a CUDA device launch the kernel or raise — there is no
fallback from the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import LIBRARY, check_operands
from repro_torch.kernels.rank_popcount import ref

BLK = ref.BLK


def block_popcounts(words: torch.Tensor) -> torch.Tensor:
    """(n_words,) int32 (read as uint32), n_words a positive multiple of
    256 -> (n_words / 256,) int32 set-bit counts per block."""
    if words.device.type == "cpu":
        return ref.block_popcounts_ref(words)
    check_operands("block_popcounts", words=words)
    n = words.shape[0]
    if words.dim() != 1 or n == 0 or n % BLK:
        raise ValueError(f"block_popcounts: words has shape "
                         f"{tuple(words.shape)}, expected (k * {BLK},), "
                         f"k > 0")
    if words.data_ptr() % 16:
        raise ValueError("block_popcounts: words must be 16-byte aligned")
    out = torch.empty((n // BLK,), dtype=torch.int32, device=words.device)
    fn = LIBRARY.function("repro_block_popcounts", 2, 1)
    err = fn(words.data_ptr(), out.data_ptr(), n // BLK,
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"block_popcounts launch failed: CUDA error {err}")
    block_popcounts.launches += 1
    return out


block_popcounts.launches = 0    # kernel launches (CPU calls excluded)
