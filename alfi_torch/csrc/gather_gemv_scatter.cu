// Fused, masked gather-GEMV-scatter for the AL multigrid cycle, in f64 on
// Hopper.  For every output dof k in [0, n):
//
//   acc[k] = sum over the CSR slots s of k, in list order, of
//            sum_j A[b, i, j] * xin[gidx[b, j]]     (b = s / m, i = s % m)
//   out[k] = out_mask[k] ? acc[k] : pass[k]        (no out_mask: acc[k])
//
// i.e. out = mask * sum_b S_b^T A_b S_b (mask * x) + (1 - mask) * pass, in
// one launch with a plain C interface (bound by ctypes from
// alfi_torch/kernels.py, whose GatherGemvScatter builds the tables once
// and checks every argument).  The input mask is folded into the gather
// table on the host: gidx[b, j] is -1 for an index-table pad and for a dof
// whose in-mask is 0, and -1 reads 0.  The CSR lists of dofs whose
// out-mask is 0 are empty, so their A rows are never read.
//
// Uses on the almg main path:
//   K1  patch apply: A_b = explicit patch inverses, idx = PatchSet.dofs,
//       which holds no masked dof, so no in-mask (smoother PC with the
//       level's BC mask out and pass = r; Schoeberl patch solves bare).
//       Replaces the TPU kernel alfi_tpu/solvers/patch_pallas.py
//       _gemv_kernel / apply_transposed_pallas (pallas_call at :81;
//       deleted in aaee1ce, read it with
//       `git show aaee1ce^:alfi_tpu/solvers/patch_pallas.py`).
//   K2  level matvec: A_b = per-cell element tensors, idx = MGLevel.rows,
//       the level's BC mask in and out, pass = v.  Replaces the plain-XLA
//       batch-major branch of alfi_tpu/mg/velocity.py:VelocityMG.level_apply
//       (:437-440) and its mask arithmetic.
//
// What bounds it on the card: bytes.  Each A entry that is read is used
// for one multiply-add, 1/8 flop per byte, far below the f64 ridge point.
// Counted once each at the 2D bench config's fine level (ldc2d baseN=16,
// nref=2, n = 33,282): K1 reads at most 4,225 x 14 x 14 x 8 B = 6.6 MB of
// inverses, K2 at most 8,192 x 12 x 12 x 8 B = 9.4 MB of element tensors
// (pad rows and rows of masked-out dofs are not read); the index table,
// x, pass and out add under 1.5 MB.  At 3.35 TB/s that is at most about
// 2.3 and 3.2 us; chip_smoke.py counts each table's bytes exactly.
//
// What the design does about it (the pair path, even m <= 64): every A
// row is read once, in one pass, with 16-byte loads, and nothing else
// goes through device memory: no intermediate Y, no second launch, no
// atomics.  A group of G lanes
// (G = the power of two >= m/2, at most 32; 8 for m = 12 and 14, 4 for
// m = 6) owns one output dof; lane t of the group loads the pair of
// columns j = 2t, 2t+1 of each owned A row as one double2 and the
// matching pair of gather indices as one int2, so a row is one contiguous
// 16-byte-per-lane load.  The gathers of x and of the index rows hit L2
// (x is 0.27 MB at nref=2, 1.1 MB at nref=3).
//
// Summation order (deterministic, no atomics: the same inputs give the
// same bits on every run): lane t keeps one f64 partial, updated with fma
// over its columns j = 2t, 2t+1 of each slot, slots in CSR list order
// (ascending flat position b*m + i); then the G partials
// are added by an xor butterfly (offsets G/2, ..., 1), which gives every
// lane the same bits since f64 addition commutes exactly.
//
// Why no tensor cores: the work is a matrix-vector product per block at
// 1/8 flop per byte; f64 DMMA would raise the flop rate of work whose
// time is all in moving A.
//
// Every block size.  The pair path above takes an even m in [2, 64] and a
// 16-byte-aligned A: every 2D table of the main path (m = 6, 12, 14) and
// the even 3D ones (the K2 tables, nld = 42 for [P2+FB]^3 and 24 for
// [P1+FB]^3).  The 3D patch tables are odd or longer: star patches of
// [P2+FB]^3 have m = 189, of [P1+FB]^3 m = 138, the Schoeberl patches
// m = 27.  They take the strided path (gather_gemv_scatter_strided_kernel),
// which has no upper limit on m:
//
//   * Row length.  A group of G lanes walks a row in steps of G columns,
//     lane t taking columns t, t + G, t + 2G, ...; a lane loads four
//     steps before it uses the first.  G is the power of two >= m/4, at
//     most 32: a whole warp per output dof from m = 65 on (a row of 189
//     doubles, 1,512 B, is six coalesced 256-byte steps), 8 lanes at
//     m = 27, so that a short row is still one batch of loads and a warp
//     carries four dofs.  A dof of a Schoeberl table owns one row, and
//     with a warp per dof the launch was a chain of dependent loads per
//     wave of blocks: 57 us at 3,072 x 27 against 23 us for the plain
//     version (NVIDIA H100 80GB HBM3, 700 W).
//   * Odd m and alignment.  A stays dense, (nb, m, m) with no pad, and is
//     read as 8-byte scalars: a row starts 16-byte aligned only when m is
//     even, and an f64 load per lane still coalesces to full 32-byte
//     sectors (a step that straddles a sector shares it with the next
//     step, which finds it in L1/L2).  A padded leading dimension would
//     buy 16-byte loads at the price of a second layout for the patch
//     inverses and 1-4 % more bytes, in a kernel whose time is bytes.
//   * Bytes at scale.  At the 3D scale row (ldc3d baseN=4 nref=2, n =
//     259,875 velocity dofs) the fine star table is 4,913 x 189 x 189 x 8 B
//     = 1.40 GB and the fine K2 table 24,576 x 42 x 42 x 8 B = 0.35 GB:
//     neither stays in the 50 MB L2, and every row is read exactly once.
//     A dof has at most 3 slots in a star table and up to 30 in the K2
//     table.  Four steps of a row (1 KB per warp) are loaded before the
//     first is used, and the SM holds 64 such warps, about 64 KB in
//     flight against the 15-20 KB that cover HBM latency at the SM's
//     share of 3.35 TB/s.  The gather row and x come from L2 (the index
//     table is 3.7 MB, x 2.1 MB); the three components of a node are
//     neighbours in k and share their patches, so the warps of a block
//     find each other's gather rows and x in L1.
//   * Summation order on the strided path: lane t keeps one f64 partial,
//     updated with fma over its columns t, t + G, ... in ascending order,
//     slots in CSR list order, then the same xor butterfly.
//
// path = 0 picks by m (pair where it applies: it is the faster of the two
// at the 2D shapes and keeps their times); 1 and 2 force a path, for
// measurements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 64;

// One lane's column pair j, j+1 of the A row of slot s and of its
// block's gather row.  Loaded first and added later, so that two slots'
// loads are in flight together.
struct ColPair {
  double2 a;
  int2 g;

  __device__ __forceinline__ ColPair(const double* __restrict__ A,
                                     const int* __restrict__ gidx, int s,
                                     int m, int j)
      : a(*reinterpret_cast<const double2*>(A + (long long)s * m + j)),
        g(*reinterpret_cast<const int2*>(gidx + (long long)(s / m) * m +
                                         j)) {}

  // p + a . x[g] in column order; a pad (-1) reads 0
  __device__ __forceinline__ double add(const double* __restrict__ x,
                                        double p) const {
    p = fma(a.x, g.x >= 0 ? x[g.x] : 0.0, p);
    return fma(a.y, g.y >= 0 ? x[g.y] : 0.0, p);
  }
};

__global__ void __launch_bounds__(kThreads)
gather_gemv_scatter_kernel(const double* __restrict__ A,
                           const double* __restrict__ x,
                           const int* __restrict__ gidx,
                           const int* __restrict__ offsets,
                           const int* __restrict__ slots,
                           const unsigned char* __restrict__ out_mask,
                           const double* __restrict__ pass,
                           double* __restrict__ out, int n, int m,
                           int glog) {
  const int G = 1 << glog;
  const long long k =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> glog;
  const int j = 2 * (threadIdx.x & (G - 1));
  const bool own = k < n;
  // a dof whose out-mask is 0 has an empty list (the host drops its
  // slots), so the mask is needed only for the final select
  const bool keep = !own || out_mask == nullptr || out_mask[k] != 0;
  int q = own ? offsets[k] : 0;
  const int qend = own ? offsets[k + 1] : 0;
  double p = 0.0;
  if (j < m) {
    // two slots per step, added in list order
    for (; q + 1 < qend; q += 2) {
      const ColPair c0(A, gidx, slots[q], m, j);
      const ColPair c1(A, gidx, slots[q + 1], m, j);
      p = c1.add(x, c0.add(x, p));
    }
    if (q < qend) p = ColPair(A, gidx, slots[q], m, j).add(x, p);
  }
  // every lane of the warp reaches this point (no early return), so the
  // full-warp shuffles are safe; offsets < G stay inside the group
  for (int o = G >> 1; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if (own && j == 0) out[k] = keep ? p : pass[k];
}

// The strided path: any m >= 1.  Lane t of a group of G = 2^glog lanes
// takes columns t, t + G, ... of each row of its dof, as 8-byte loads.
constexpr int kSteps = 4;  // steps of a row loaded before the first is used

__global__ void __launch_bounds__(kThreads)
gather_gemv_scatter_strided_kernel(const double* __restrict__ A,
                                   const double* __restrict__ x,
                                   const int* __restrict__ gidx,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ slots,
                                   const unsigned char* __restrict__ out_mask,
                                   const double* __restrict__ pass,
                                   double* __restrict__ out, int n, int m,
                                   int glog) {
  const int G = 1 << glog;
  const long long k =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> glog;
  const int t = threadIdx.x & (G - 1);
  const bool own = k < n;
  const bool keep = !own || out_mask == nullptr || out_mask[k] != 0;
  const int qbeg = own ? offsets[k] : 0;
  const int qend = own ? offsets[k + 1] : 0;
  double p = 0.0;
  for (int q = qbeg; q < qend; ++q) {
    const int s = slots[q];
    const double* __restrict__ row = A + (long long)s * m;
    const int* __restrict__ grow = gidx + (long long)(s / m) * m;
    for (int j0 = t; j0 < m; j0 += kSteps * G) {
      double a[kSteps];
      int g[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int j = j0 + u * G;
        const bool in = j < m;
        a[u] = in ? row[j] : 0.0;
        g[u] = in ? grow[j] : -1;
      }
      double xv[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) xv[u] = g[u] >= 0 ? x[g[u]] : 0.0;
      // ascending columns; a step past the row's end adds 0 * 0
#pragma unroll
      for (int u = 0; u < kSteps; ++u) p = fma(a[u], xv[u], p);
    }
  }
  // every lane of the warp reaches this point, as in the pair kernel
  for (int o = G >> 1; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if (own && t == 0) out[k] = keep ? p : pass[k];
}

}  // namespace

extern "C" {

// out (n,) = the fused, masked gather-GEMV-scatter above, launched on
// `stream` of CUDA device `device`.  Any m >= 1; path 0 picks the kernel
// by m, 1 forces the pair kernel (m even in [2, 64], A 16-byte and gidx
// 8-byte aligned), 2 the strided one.  out_mask and pass both null or both
// set.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for arguments it does not take).
int alfi_gather_gemv_scatter(const double* A, const double* x,
                             const int* gidx, const int* offsets,
                             const int* slots,
                             const unsigned char* out_mask,
                             const double* pass, double* out, int n, int m,
                             int path, int device, void* stream) {
  if (n < 0 || m < 1 || path < 0 || path > 2 ||
      (out_mask == nullptr) != (pass == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool pair_ok = m <= kMaxM && m % 2 == 0 &&
                       reinterpret_cast<unsigned long long>(A) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(gidx) % 8 == 0;
  if (path == 1 && !pair_ok) return (int)cudaErrorInvalidValue;
  const bool pair = path == 1 || (path == 0 && pair_ok);
  if (n == 0) return (int)cudaSuccess;
  // lanes per dof: one per column pair (pair), or as many as load the
  // row in one batch of kSteps steps (strided)
  const int width = pair ? m / 2 : (m + kSteps - 1) / kSteps;
  int glog = 0;
  while (glog < 5 && (1 << glog) < width) ++glog;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const long long threads = (long long)n << glog;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  if (pair)
    gather_gemv_scatter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        A, x, gidx, offsets, slots, out_mask, pass, out, n, m, glog);
  else
    gather_gemv_scatter_strided_kernel<<<grid, kThreads, 0,
                                         (cudaStream_t)stream>>>(
        A, x, gidx, offsets, slots, out_mask, pass, out, n, m, glog);
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

}  // extern "C"
