// Rank-dictionary block popcounts (the succinct tree's rank1 directory).
//
// Replaces the TPU kernel src/repro/kernels/rank_popcount/kernel.py,
// function _kernel (launched by block_popcounts): for every block of 256
// 32-bit words it writes the number of set bits in the block, as int32.
// The exclusive prefix over the blocks is the caller's (ops.py).
//
// What bounds it on an H100: the read of the words, 4 bytes a word
// (5.2 MB for a 42 Mbit bitmap, about 1.6 us at 3.35 TB/s); one popc and
// one add a word are far below the card's integer rate, and the output
// is 1/256 of the input.  At these sizes the launch itself is of the
// same order as the bound.
//
// What the simple design does about it: one warp per block.  Each lane
// reads two 16-byte vectors (the warp's 32 lanes read 512 contiguous
// bytes per load), sums __popc of its eight words, and a shuffle
// reduction gives the block's sum to lane 0.  The TPU's SWAR popcount
// becomes the hardware population count.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 256;               // words per rank block
constexpr int WARPS = 8;               // warps (= rank blocks) per block

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
block_popcount_kernel(const uint4* __restrict__ words,  // (n_blocks * 256)
                      int* __restrict__ out,            // (n_blocks)
                      int n_blocks) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= n_blocks) return;  // uniform per warp: the shuffles stay full
  const uint4* blk = words + static_cast<size_t>(b) * (BLK / 4);
  int s = 0;
#pragma unroll
  for (int i = lane; i < BLK / 4; i += 32) {
    const uint4 v = __ldg(blk + i);
    s += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  s = warp_sum(s);
  if (lane == 0) out[b] = s;
}

}  // namespace

// words must be 16-byte aligned and hold n_blocks * 256 words; the
// Python wrapper checks it before the call.
extern "C" int repro_block_popcounts(const void* words, void* out,
                                     int n_blocks, void* stream) {
  const dim3 grid((n_blocks + WARPS - 1) / WARPS);
  block_popcount_kernel<<<grid, WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), static_cast<int*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}
