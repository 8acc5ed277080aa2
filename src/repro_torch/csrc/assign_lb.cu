// Batched Hausdorff branch lower bound, stage 1.5 (DESIGN.md §16).
//
// Replaces the TPU kernel src/repro/kernels/assign_lb/kernel.py, function
// _lb_kernel (launched by assign_lb_call).  For every (query q, graph n)
// pair, with doubled integer branch costs
//   C2(u, v) = 2*[l(u) != l(v)] + max(d(u), d(v)) - sum_e min(EH_u[e], EH_v[e])
//   rowsum   = sum over the first qn[q] query vertices of
//              min(min_v C2(u, v), 2 + d(u))
//   colsum   = sum over the first dn[n] db vertices of
//              min(min_u C2(u, v), 2 + d(v))
//   LB       = (max(rowsum, colsum) + 1) // 2.
// Pad vertices (label -1, degree 0, zero histograms) price exactly as the
// epsilon column, so the mins run over every padded vertex and only the
// two sums mask, as in the reference.
//
// What bounds it on an H100: launch latency and integer arithmetic.  A
// main-path launch is Q=8 queries x N<=64 survivors x VMq<=64 x VM=56
// branch pairs at about a dozen integer ops each (about 2*10^7 ops, under
// 2*10^5 per SM) on well under 1 MB of operands, so the work itself is a
// fraction of a microsecond and the launch dominates.
//
// What the simple design does about it: one warp per (query, graph) pair,
// so a bucket's few hundred pairs fill the SMs with independent warps.
// Each lane owns up to VPL db vertices (VM <= 32*VPL) and keeps their
// labels, degrees and running column mins in registers; the query-vertex
// loop runs to the runtime VMq (no unroll by shape), each row min is a
// warp-shuffle min, and the column sum a warp-shuffle sum.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // warps (= pairs) per block
constexpr int VPL = 8;     // db vertices per lane: VM <= 256

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(WARPS * 32)
assign_lb_kernel(const int* __restrict__ qv,    // (Q, VMq) labels, pad -1
                 const int* __restrict__ qd,    // (Q, VMq) degrees, pad 0
                 const int* __restrict__ qeh,   // (Q, VMq, NE)
                 const int* __restrict__ qn,    // (Q,) true vertex counts
                 const int* __restrict__ dv,    // (N, VM)
                 const int* __restrict__ dd,    // (N, VM)
                 const int* __restrict__ deh,   // (N, VM, NE)
                 const int* __restrict__ dn,    // (N,)
                 int* __restrict__ out,         // (Q, N)
                 int Q, int N, int VMq, int VM, int NE) {
  const int lane = threadIdx.x & 31;
  const long pair = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= (long)Q * N) return;  // uniform per warp
  const int q = (int)(pair / N);
  const int n = (int)(pair % N);

  const int* qvr = qv + (size_t)q * VMq;
  const int* qdr = qd + (size_t)q * VMq;
  const int* qehr = qeh + (size_t)q * VMq * NE;
  const int* dehr = deh + (size_t)n * VM * NE;

  int lab[VPL], deg[VPL], colmin[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int v = lane + 32 * k;
    lab[k] = v < VM ? dv[(size_t)n * VM + v] : -1;
    deg[k] = v < VM ? dd[(size_t)n * VM + v] : 0;
    colmin[k] = 2 + deg[k];          // the epsilon row
  }

  const int nq = qn[q];
  int rowsum = 0;
  for (int u = 0; u < VMq; ++u) {
    const int lu = qvr[u];
    const int du = qdr[u];
    int rmin = 2 + du;               // the epsilon column
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int v = lane + 32 * k;
      if (v < VM) {
        int inter = 0;
        for (int e = 0; e < NE; ++e)
          inter += min(qehr[u * NE + e], dehr[v * NE + e]);
        const int c2 = 2 * (lu != lab[k]) + max(du, deg[k]) - inter;
        rmin = min(rmin, c2);
        colmin[k] = min(colmin[k], c2);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      rmin = min(rmin, __shfl_xor_sync(0xffffffffu, rmin, o));
    if (u < nq) rowsum += rmin;      // nq is uniform across the warp
  }

  const int ndb = dn[n];
  int colsum = 0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int v = lane + 32 * k;
    if (v < VM && v < ndb) colsum += colmin[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    colsum += __shfl_xor_sync(0xffffffffu, colsum, o);
  if (lane == 0) out[(size_t)q * N + n] = floor_div(max(rowsum, colsum) + 1, 2);
}

}  // namespace

// VM must be at most 32 * VPL; the Python wrapper checks it.
extern "C" int repro_assign_lb(const void* qv, const void* qd,
                               const void* qeh, const void* qn,
                               const void* dv, const void* dd,
                               const void* deh, const void* dn, void* out,
                               int Q, int N, int VMq, int VM, int NE,
                               void* stream) {
  const long pairs = (long)Q * N;
  const dim3 grid((unsigned)((pairs + WARPS - 1) / WARPS));
  assign_lb_kernel<<<grid, WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qv), static_cast<const int*>(qd),
      static_cast<const int*>(qeh), static_cast<const int*>(qn),
      static_cast<const int*>(dv), static_cast<const int*>(dd),
      static_cast<const int*>(deh), static_cast<const int*>(dn),
      static_cast<int*>(out), Q, N, VMq, VM, NE);
  return static_cast<int>(cudaGetLastError());
}
