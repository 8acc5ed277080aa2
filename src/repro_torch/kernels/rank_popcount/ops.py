"""Build and query the two-level rank dictionary.

The succinct tree's B_X bitmaps need O(1) rank1.  The dictionary is the
per-block popcount sums (the kernel, ``kernel.block_popcounts``) plus
their exclusive prefix; ``rank1_query`` adds the whole words before the
index inside its block and the head of its word.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.rank_popcount.ref import BLK


def pack_bits_u32(bits: np.ndarray) -> np.ndarray:
    """0/1 array -> uint32 words (MSB-first), zero-padded to BLK words."""
    bits = np.asarray(bits, np.uint8)
    pad = (-len(bits)) % 32
    b = np.pad(bits, (0, pad))
    bytes_ = np.packbits(b)
    pad4 = (-len(bytes_)) % 4
    bytes_ = np.pad(bytes_, (0, pad4))
    words = bytes_.view(">u4").astype(np.uint32)
    padw = (-len(words)) % BLK
    return np.pad(words, (0, padw))


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each word's unsigned 32 bits -> int32 (plain
    tensor arithmetic in int64)."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def build_rank_dictionary(bits: np.ndarray, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(words, cum): the packed words as int32 on ``device`` (the CUDA
    device unless the caller names another) and the (n_blocks + 1,)
    exclusive block prefix sums.  On a CUDA device the block sums are the
    kernel, on the CPU its plain version."""
    from repro_torch.kernels.rank_popcount.kernel import block_popcounts
    dev = torch.device("cuda" if device is None else device)
    words = torch.from_numpy(pack_bits_u32(bits).view(np.int32)).to(dev)
    pc = block_popcounts(words)
    cum = torch.cat([pc.new_zeros(1),
                     torch.cumsum(pc, 0, dtype=torch.int32)])
    return words, cum


def rank1_query(words: torch.Tensor, cum: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Vectorised rank1 (ones in [0, idx)) using the dictionary, for any
    0 <= idx <= 32 * len(words)."""
    idx = idx.long()
    w = idx // 32
    rem = idx % 32
    blk = w // BLK
    base = cum.long()[blk]
    word_pc = popcount_u32(words).long()
    word_cum = torch.cat([word_pc.new_zeros(1), torch.cumsum(word_pc, 0)])
    mid = word_cum[w] - word_cum[blk * BLK]
    # idx at the very end names the word past the last; its head is empty
    word = words.long()[w.clamp(max=len(words) - 1)] & 0xFFFFFFFF
    head = torch.where(rem > 0,
                       popcount_u32(word >> (32 - rem).clamp(max=31)).long(),
                       torch.zeros_like(rem))
    return (base + mid + head).to(torch.int32)
