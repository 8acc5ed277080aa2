"""Plain PyTorch versions of the rank dictionary: bit-by-bit oracles
(independent of the kernel's hardware popcount), on any device.

Words are int32 tensors read as their unsigned 32 bits, MSB first.
"""
from __future__ import annotations

import torch

BLK = 256  # words per rank block (8192 bits)


def popcount_u32_ref(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word, one bit at a time -> int32."""
    x = x.long() & 0xFFFFFFFF
    total = torch.zeros_like(x)
    for b in range(32):
        total += (x >> b) & 1
    return total.to(torch.int32)


def block_popcounts_ref(words: torch.Tensor) -> torch.Tensor:
    """(n_words,) -> (n_words / 256,) int32 block popcounts; the contract
    of ``kernel.block_popcounts``."""
    n = words.shape[0]
    if n % BLK:
        raise ValueError(f"block_popcounts: {n} words is not a multiple "
                         f"of {BLK}")
    return popcount_u32_ref(words).reshape(n // BLK, BLK).sum(
        1, dtype=torch.int32)


def rank1_query_ref(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rank1 (ones in [0, idx)) by full bit expansion — oracle only."""
    w = words.long() & 0xFFFFFFFF
    shifts = 31 - torch.arange(32, device=words.device)
    bits = ((w[:, None] >> shifts[None, :]) & 1).reshape(-1)
    cum = torch.cat([bits.new_zeros(1), torch.cumsum(bits, 0)])
    return cum[idx.long()].to(torch.int32)
