// Fused q-gram filter cascade, query-batched and single-query
// (DESIGN.md §13).
//
// Replaces two TPU kernels of src/repro/kernels/qgram_filter/kernel.py:
// _batched_kernel (launched by fused_batched_call; entry point
// repro_qgram_filter, QC = 8 queries a register chunk, aux (B, 4), C_D
// seed from cdt) and _kernel (launched by fused_filter_call; entry point
// repro_qgram_filter_single, QC = 1, aux (B, 5) whose column 4 is the
// C_D seed).  Both are one template.  For every (query q, graph b) pair
// it computes
//   C_D   = seed[q, b] + sum_u min(F_D[b, u], qfd[q, u])
//   C_Lv  = sum min(vhist[b], qvh[q]),  C_Le = sum min(ehist[b], qeh[q])
//   the number-count, label-q-gram, degree-q-gram and Lemma-5
//   degree-sequence bounds, bound = their max, and
//   mask  = (b lies in q's reduced query region, formula (1)) & bound <= tau.
// All arithmetic is int32 and bit-identical to the reference.
//
// What bounds it on an H100: the F_D stream.  Every launch must read the
// (B, U) int32 slab once, B*U*4 bytes: about 84 MB for a 10240 x 2048
// padded bucket, about 25 us at 3.35 TB/s.  Everything else (the query
// block, histograms, degree sequences, the (Q, B) outputs) is under 5% of
// those bytes, and the min/add work (about 2 integer ops per F_D entry
// and query) is far below the card's integer rate.
//
// What the simple design does about it: one warp per graph row.  The
// lanes sweep the row with 16-byte loads (so the slab is read once,
// coalesced, with no grid axis over U: the TPU grid's sequential vocab
// axis becomes this loop), and each loaded F_D vector serves a chunk of
// QC queries whose C_D sums stay in registers; the query rows themselves
// are re-read from L1/L2.  The small per-graph reductions (label
// histograms, degree sequences) are spread over the same lanes, the 6*QC
// partial sums are reduced with warp shuffles, and lane j writes the
// epilogue of query j.  Query blocks wider than QC re-sweep the row once
// per chunk.  The single-query instance has QC = 1: each F_D vector meets
// one query vector, so it does an eighth of the batched instance's work
// per byte instead of padding one query to a chunk of 8.  Not done yet:
// F_D tiles staged in shared memory, a query-sparse C_D, one launch for
// all buckets.
//
// Region bounds floor-divide numerators that go negative; C's `/`
// truncates toward zero, so every `//` of the reference is floor_div.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;       // warps (= graph rows) per block
constexpr int N_SCALARS = 6;   // q_nv, q_ne, tau, x0, y0, l

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int min4(int4 a, int4 b) {
  return min(a.x, b.x) + min(a.y, b.y) + min(a.z, b.z) + min(a.w, b.w);
}

// QC: queries per register chunk; AUX_COLS: 4 (nv ne ri rj) or 5 (and
// the C_D seed in column 4)
template <int QC, int AUX_COLS>
__global__ void __launch_bounds__(WARPS * 32)
qgram_filter_kernel(const int* __restrict__ scalars,  // (Q, 6)
                    const int* __restrict__ fd,       // (B, U)
                    const int* __restrict__ qfd,      // (Q, U)
                    const int* __restrict__ vhist,    // (B, NV)
                    const int* __restrict__ qvh,      // (Q, NV)
                    const int* __restrict__ ehist,    // (B, NE)
                    const int* __restrict__ qeh,      // (Q, NE)
                    const int* __restrict__ degseq,   // (B, VM)
                    const int* __restrict__ qsig,     // (Q, VM)
                    const int* __restrict__ aux,      // (B, AUX_COLS)
                    const int* __restrict__ cdt,      // (Q, B) or null
                    int* __restrict__ bounds,         // (Q, B) out
                    int* __restrict__ mask,           // (Q, B) out
                    int Q, int B, int U, int NV, int NE, int VM) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp: the shuffles below stay full

  const int U4 = U >> 2;
  const int4* row = reinterpret_cast<const int4*>(fd + (size_t)b * U);
  const int* vrow = vhist + (size_t)b * NV;
  const int* erow = ehist + (size_t)b * NE;
  const int* drow = degseq + (size_t)b * VM;
  const int nv = aux[AUX_COLS * b + 0];
  const int ne = aux[AUX_COLS * b + 1];
  const int ri = aux[AUX_COLS * b + 2];
  const int rj = aux[AUX_COLS * b + 3];
  int seed = 0;
  if constexpr (AUX_COLS == 5) seed = aux[AUX_COLS * b + 4];

  for (int q0 = 0; q0 < Q; q0 += QC) {
    int cd[QC], ov[QC], oe[QC], s1[QC], s2[QC], md[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      cd[j] = ov[j] = oe[j] = s1[j] = s2[j] = md[j] = 0;
    }
    const int4* qrow = reinterpret_cast<const int4*>(qfd + (size_t)q0 * U);
    for (int k = lane; k < U4; k += 32) {
      const int4 f = __ldg(row + k);
#pragma unroll
      for (int j = 0; j < QC; ++j) cd[j] += min4(f, __ldg(qrow + j * U4 + k));
    }
    for (int k = lane; k < NV; k += 32) {
      const int v = vrow[k];
#pragma unroll
      for (int j = 0; j < QC; ++j) ov[j] += min(v, qvh[(q0 + j) * NV + k]);
    }
    for (int k = lane; k < NE; k += 32) {
      const int e = erow[k];
#pragma unroll
      for (int j = 0; j < QC; ++j) oe[j] += min(e, qeh[(q0 + j) * NE + k]);
    }
    for (int k = lane; k < VM; k += 32) {
      const int d = drow[k];
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int s = qsig[(q0 + j) * VM + k];
        s1[j] += max(d - s, 0);
        s2[j] += max(s - d, 0);
        md[j] += min(d, s);
      }
    }
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      cd[j] = warp_sum(cd[j]);
      ov[j] = warp_sum(ov[j]);
      oe[j] = warp_sum(oe[j]);
      s1[j] = warp_sum(s1[j]);
      s2[j] = warp_sum(s2[j]);
      md[j] = warp_sum(md[j]);
    }
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      if (lane != j) continue;
      const int q = q0 + j;
      const int* sc = scalars + q * N_SCALARS;
      const int q_nv = sc[0], q_ne = sc[1], tau = sc[2];
      const int x0 = sc[3], y0 = sc[4], l = sc[5];
      const int c_d =
          cd[j] + seed + (cdt != nullptr ? cdt[(size_t)q * B + b] : 0);
      const int max_nv = max(nv, q_nv);
      const int max_ne = max(ne, q_ne);
      const int number_count = abs(nv - q_nv) + abs(ne - q_ne);
      const int label_qgram = max_nv + max_ne - (ov[j] + oe[j]);
      const int degree_qgram =
          max(0, floor_div(2 * max_nv - ov[j] - c_d + 1, 2));
      const int delta = floor_div(s1[j] + 1, 2) + floor_div(s2[j] + 1, 2);
      const int lam2 = max(q_ne + ne - md[j], 0);
      const int lam = (q_nv <= nv) ? delta : lam2;
      const int degree_sequence = max_nv - ov[j] + lam;
      const int bound = max(max(number_count, label_qgram),
                            max(degree_qgram, degree_sequence));
      const int s = x0 + y0, dd = y0 - x0;
      const int i1 = floor_div(q_ne - tau + q_nv - s, l);
      const int i2 = floor_div(q_ne + tau + q_nv - s, l);
      const int j1 = floor_div(q_ne - tau - q_nv - dd, l);
      const int j2 = floor_div(q_ne + tau - q_nv - dd, l);
      const bool in_region = ri >= i1 && ri <= i2 && rj >= j1 && rj <= j2;
      bounds[(size_t)q * B + b] = bound;
      mask[(size_t)q * B + b] = (in_region && bound <= tau) ? 1 : 0;
    }
  }
}

}  // namespace

// Q must be a multiple of 8 and U of 4, with fd / qfd 16-byte aligned;
// the Python wrapper checks all of it before the call.
extern "C" int repro_qgram_filter(const void* scalars, const void* fd,
                                  const void* qfd, const void* vhist,
                                  const void* qvh, const void* ehist,
                                  const void* qeh, const void* degseq,
                                  const void* qsig, const void* aux,
                                  const void* cdt, void* bounds, void* mask,
                                  int Q, int B, int U, int NV, int NE, int VM,
                                  void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  qgram_filter_kernel<8, 4><<<grid, WARPS * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(scalars), static_cast<const int*>(fd),
      static_cast<const int*>(qfd), static_cast<const int*>(vhist),
      static_cast<const int*>(qvh), static_cast<const int*>(ehist),
      static_cast<const int*>(qeh), static_cast<const int*>(degseq),
      static_cast<const int*>(qsig), static_cast<const int*>(aux),
      static_cast<const int*>(cdt), static_cast<int*>(bounds),
      static_cast<int*>(mask), Q, B, U, NV, NE, VM);
  return static_cast<int>(cudaGetLastError());
}

// One query: scalars (6,), qfd (U,), qvh (NV,), qeh (NE,), qsig (VM,),
// aux (B, 5) with the C_D seed in column 4; outputs (B,).  U must be a
// multiple of 4, with fd / qfd 16-byte aligned (checked by the wrapper).
extern "C" int repro_qgram_filter_single(
    const void* scalars, const void* fd, const void* qfd, const void* vhist,
    const void* qvh, const void* ehist, const void* qeh, const void* degseq,
    const void* qsig, const void* aux, void* bounds, void* mask, int B,
    int U, int NV, int NE, int VM, void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  qgram_filter_kernel<1, 5><<<grid, WARPS * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(scalars), static_cast<const int*>(fd),
      static_cast<const int*>(qfd), static_cast<const int*>(vhist),
      static_cast<const int*>(qvh), static_cast<const int*>(ehist),
      static_cast<const int*>(qeh), static_cast<const int*>(degseq),
      static_cast<const int*>(qsig), static_cast<const int*>(aux), nullptr,
      static_cast<int*>(bounds), static_cast<int*>(mask), 1, B, U, NV, NE,
      VM);
  return static_cast<int>(cudaGetLastError());
}
