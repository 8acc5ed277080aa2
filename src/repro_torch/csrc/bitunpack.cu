// Hybrid bit-packed block decode (DESIGN.md §3, §11).
//
// Replaces the TPU kernel src/repro/kernels/bitunpack/kernel.py, function
// _kernel (launched by bitunpack_call).  Block k of the packed stream
// holds 128 entries at width w = widths[k] in {2, 4, 8, 16, 32}, starting
// at word sb[k]; entry e sits at bit e*w of that window, MSB-first within
// its 32-bit word (w divides 32, so no entry straddles a word).  Values
// come back as int32 with the same 32 bits, so a width-32 value >= 2^31
// is negative, as in the reference.
//
// Two forms, one kernel:
//   flat  (row_words = 0): sb holds absolute word offsets into one
//         stream; out is (n_blocks, 128), one block per row (kb = 1).
//   rows  (row_words = W): words is (B, W), sb / widths are (B, kb) with
//         offsets relative to the row; out is (B, out_cols) with the
//         decoded kb*128 columns followed by zeros.  This is the packed
//         FilterSlab's per-bucket decode: it writes the zero-padded F_D
//         block the filter kernel reads, so no second copy pads it, and
//         the row base is computed here in 64 bits, so no int32 flat
//         offset limits the bucket size.
//
// What bounds it on an H100: the write of the decoded block.  A
// 10,240-row bucket at out_cols = 2048 writes 84 MB (about 25 us at
// 3.35 TB/s) and reads under a tenth of that (the payload is 2-4 bits an
// entry on msq_aids).  The shifts and masks are a few integer operations
// an entry, far below the card's integer rate.
//
// What the simple design does about it: one thread per four output
// entries, storing them as one 16-byte int4, so a warp writes 512
// contiguous bytes.  With out_cols a multiple of 128 (the wrapper checks)
// a warp covers exactly one 128-entry block: the block's offset and
// width are one broadcast load, and its at most 4*w payload words come
// through L1.  Widths that do not divide 32 are not part of the format
// and decode to zeros instead of shifting out of range; the w = 32 mask
// is written out, since 1u << 32 is undefined in C++.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_ENTRIES = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ int entry(const unsigned* __restrict__ words,
                                     size_t base, int e, int w,
                                     unsigned mask) {
  const int bit = e * w;
  const unsigned word = __ldg(words + base + (bit >> 5));
  // bit & 31 is a multiple of w no larger than 32 - w: shift in [0, 31]
  return static_cast<int>((word >> (32 - w - (bit & 31))) & mask);
}

__global__ void __launch_bounds__(THREADS)
bitunpack_kernel(const int* __restrict__ sb,          // (n_rows * kb)
                 const int* __restrict__ widths,      // (n_rows * kb)
                 const unsigned* __restrict__ words,  // stream or (B, W)
                 int4* __restrict__ out,              // (n_rows, out_cols)
                 long long n_rows, int kb, long long row_words,
                 int out_cols) {
  const long long quads = out_cols >> 2;
  const long long t = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (t >= n_rows * quads) return;
  const long long r = t / quads;
  const int c = static_cast<int>(t - r * quads) << 2;
  int4 v = make_int4(0, 0, 0, 0);
  if (c < kb * BLOCK_ENTRIES) {
    const long long g = r * kb + (c / BLOCK_ENTRIES);
    const int w = __ldg(widths + g);
    if (w > 0 && w <= 32 && 32 % w == 0) {
      const size_t base = static_cast<size_t>(r * row_words + __ldg(sb + g));
      const unsigned mask = w == 32 ? 0xffffffffu : (1u << w) - 1u;
      const int e = c % BLOCK_ENTRIES;
      v.x = entry(words, base, e, w, mask);
      v.y = entry(words, base, e + 1, w, mask);
      v.z = entry(words, base, e + 2, w, mask);
      v.w = entry(words, base, e + 3, w, mask);
    }
  }
  out[t] = v;
}

}  // namespace

// out_cols must be a multiple of 128 and at least kb * 128, and out
// 16-byte aligned; the Python wrapper checks all of it before the call.
extern "C" int repro_bitunpack(const void* sb, const void* widths,
                               const void* words, void* out, int n_rows,
                               int kb, int row_words, int out_cols,
                               void* stream) {
  const long long threads =
      static_cast<long long>(n_rows) * (out_cols / 4);
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS));
  bitunpack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sb), static_cast<const int*>(widths),
      static_cast<const unsigned*>(words), static_cast<int4*>(out), n_rows,
      kb, row_words, out_cols);
  return static_cast<int>(cudaGetLastError());
}
