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
//       the level's BC mask in and out, pass = v: the plain-XLA
//       batch-major branch of alfi_tpu/mg/velocity.py:VelocityMG.level_apply
//       (:437-440) and its mask arithmetic.  No longer on the main path:
//       the cycle applies the merged level operator of level_operator.cu,
//       which reads each coupling once where these blocks repeat it; the
//       blocked table stays as the yardstick chip_smoke.py times beside it.
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
// Every block size: the strided kernel.  The pair path above takes an even
// m in [2, 64] and a 16-byte-aligned A: every 2D table of the main path
// (m = 6, 12, 14) and the even 3D ones (the K2 tables, nld = 42 for
// [P2+FB]^3 and 24 for [P1+FB]^3; the Schoeberl table m = 24 of the 3D
// step).  The 3D patch tables are odd or longer (star patches of [P2+FB]^3
// have m = 189, of [P1+FB]^3 m = 138, on the step's gmsh mesh 201; the
// Schoeberl patches m = 27) and take gather_gemv_scatter_strided_kernel,
// which has no upper limit on m.
//
//   * What bounds it: the bytes of the live part of A.  The 3D tables are
//     ragged.  PatchSet pads every patch to the largest one, pads trailing,
//     and few patches are the largest: of the 4,913 fine star patches of
//     ldc3d baseN=4 nref=2 only 128 have 189 dofs (sizes 3 .. 189); on the
//     step mesh the median patch has 73.5 of 201.  The function needs
//     sum_b s_b^2 entries (0.679 GB, 0.074 GB at level 1, 0.125 GB on the
//     step mesh); whole rows of the live dofs, sum_b s_b * m, are 0.903,
//     0.107 and 0.265 GB, and the whole tables 1.40, 0.21 and 0.71 GB.
//     Each entry is used for one multiply-add: 1/8 flop per byte.
//   * Live extents.  The host gives every CSR slot the live extent of its
//     block (slot_cols, beside slots: one past the last column whose
//     gather index is >= 0).  A row is read up to there and no further, so
//     on a K1 table the bytes loaded are the bytes the bound counts; on a
//     K2 table, whose in-masked columns lie between live ones, about 6 %
//     more (a -1 before the extent reads x as 0).  A pad column would add
//     fma(a, 0, p) = p, so leaving it out changes no bit.
//   * Lanes that fit the rows.  A group of G lanes walks a row in steps of
//     G columns, lane t taking columns t, t + G, ...; kSteps = 4 steps are
//     a batch.  G is one number per table, chosen on the host from the
//     live rows' extents, not from m: the power of two, 4 .. 32, that
//     takes the 75 % row in two batches (alfi_torch/kernels.py:
//     strided_lanes_log2).  That is a warp per dof for the star tables
//     (the 75 % row has 129 columns on the step mesh, where 85 % of the
//     lanes of a step then carry a column, against 92 % with 16 lanes and
//     twice the batches per row) and 4 lanes at m = 27, so that a warp
//     carries 8 dofs of one short row each: 12.2 us at 3,072 x 27 against
//     the 17.3 of 8 lanes before this redesign (and 57 with a warp per
//     dof, a chain of dependent loads per wave of CTAs).  What it cost:
//     one width per table, so a short row of a star table still occupies
//     a warp; a per-CTA width from a host-sorted dof order would need a
//     permutation of out and was not tried.
//   * One stream of batches per dof.  The batches of all rows of a dof
//     (its CSR list in order, columns ascending) form one stream, and the
//     next batch's A entries and gather indices are loaded before this
//     batch's x is gathered; the next slot's id and extent are loaded one
//     slot ahead.  So the gather latency of x (L2) is paid once per batch
//     with a batch of A (up to 1 KB per warp) in flight behind it, not
//     after it: a row of 189 was two dependent rounds of load A, then
//     gather x; 44 registers, 40 warps per SM.
//   * What the card said about the gathers (chip_ab.py --ablate, on the
//     strided kernel before this redesign, NVIDIA H100 80GB HBM3, 700 W): with
//     x[g] replaced by a constant it ran 11 % faster at 4,913 x 189 (384
//     -> 341 us), 9 % at 729 x 189 and 2,184 x 201; with the index row
//     gone too, no faster.  So the gathers cost a tenth, the padding a
//     quarter to a half.  Staging x per block in shared memory (a warp per
//     run of rows of one block, row sums to scratch, the last row to
//     arrive at a dof adds them; no float atomics) was built and measured:
//     its integer atomic and fence per row cost more than the gathers it
//     saved, and with a second launch for the sums instead it was level
//     with this kernel on the star tables and faster only at the fine K2
//     table.  One launch and no scratch won.
//   * Odd m and alignment.  A stays dense, (nb, m, m) with no pad, and is
//     read as 8-byte scalars: a row starts 16-byte aligned only when m is
//     even, and an f64 load per lane still coalesces to full 32-byte
//     sectors.  A padded leading dimension would buy 16-byte loads at the
//     price of a second layout for the patch inverses.
//   * Summation order on the strided path: lane t keeps one f64 partial,
//     updated with fma over its columns t, t + G, ... of each row in
//     ascending order, rows in CSR list order, then the same xor
//     butterfly.  No atomics; two launches give the same bits.
//
// Which kernel takes which m (path 0), by the card's times (chip_smoke.py
// prints both kernels for every even m <= 64; NVIDIA H100 80GB HBM3, 700
// W): the pair kernel keeps every even m <= 64.  At the 2D shapes it is
// the faster (8,192 x 12: 5.0 against 5.9 us) and was designed there.  At
// the 3D K2 shapes a dof has up to 30 slots of short rows,
// and the pair kernel's warp per dof, two slots in flight, beats the
// strided kernel's few lanes per dof: 3,072 x 42: 20 against 44 us;
// 9,472 x 24: 28 against 66 us; only at 24,576 x 42 is the strided kernel
// level (154 against 162 us; cuSPARSE 133).  More slots in flight in the
// pair kernel (4 or 8 to a batch, with and without loading ahead) were
// slower at every K2 shape.  The Schoeberl table of the step (1,184 x 24,
// one slot per dof) would be faster strided (4.4 against 7.0 us); m alone
// cannot tell it from the K2 table of the same mesh, which has 6 times
// the launches.
//
// path = 0 picks by m; 1 and 2 force the pair or the strided kernel, for
// measurements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 64;

// The one write of dof k: out = keep ? p : pass.
__device__ __forceinline__ void store(double* __restrict__ out,
                                      const double* __restrict__ pass,
                                      long long k, double p, bool keep) {
  out[k] = keep ? p : pass[k];
}

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
  if (own && j == 0) store(out, pass, k, p, keep);
}

// The strided kernel: any m >= 1 (see the header note).  Lane t of a
// group of G = 2^glog lanes takes columns t, t + G, ... below the block's
// live extent of each row of its dof, as 8-byte loads, kSteps steps to a
// batch.
constexpr int kSteps = 4;

// One lane's batch: its kSteps columns j0, j0 + G, ... (those below the
// live extent nc) of the A row of slot s and of its block's gather row.
struct Batch {
  double a[kSteps];
  int g[kSteps];

  __device__ __forceinline__ void load(const double* __restrict__ A,
                                       const int* __restrict__ gidx, int s,
                                       int m, int nc, int j0, int G) {
    const double* __restrict__ row = A + (long long)s * m;
    const int* __restrict__ grow = gidx + (long long)(s / m) * m;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int j = j0 + u * G;
      const bool in = j < nc;
      a[u] = in ? row[j] : 0.0;
      g[u] = in ? grow[j] : -1;
    }
  }

  // p + a . x[g] in ascending columns; a pad (-1) reads 0, and a step
  // past the live extent adds 0 * 0
  __device__ __forceinline__ double add(const double* __restrict__ x,
                                        double p) const {
    double xv[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) xv[u] = g[u] >= 0 ? x[g[u]] : 0.0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) p = fma(a[u], xv[u], p);
    return p;
  }
};

__global__ void __launch_bounds__(kThreads)
gather_gemv_scatter_strided_kernel(const double* __restrict__ A,
                                   const double* __restrict__ x,
                                   const int* __restrict__ gidx,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ slots,
                                   const int* __restrict__ slot_cols,
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
  int q = own ? offsets[k] : 0;
  const int qend = own ? offsets[k + 1] : 0;
  double p = 0.0;
  if (q < qend) {
    // this slot and, loaded ahead, the next
    int s = slots[q], nc = slot_cols[q], sn = 0, ncn = 0;
    if (q + 1 < qend) {
      sn = slots[q + 1];
      ncn = slot_cols[q + 1];
    }
    int c0 = 0;
    Batch cur;
    cur.load(A, gidx, s, m, nc, t, G);
    // the batches of the dof's rows as one stream, in list order, columns
    // ascending: the next batch is loaded before this one's x is gathered
    while (true) {
      c0 += kSteps * G;
      if (c0 >= nc) {
        if (++q >= qend) break;
        s = sn;
        nc = ncn;
        c0 = 0;
        if (q + 1 < qend) {
          sn = slots[q + 1];
          ncn = slot_cols[q + 1];
        }
      }
      Batch nxt;
      nxt.load(A, gidx, s, m, nc, c0 + t, G);
      p = cur.add(x, p);
      cur = nxt;
    }
    p = cur.add(x, p);
  }
  // every lane of the warp reaches this point, as in the pair kernel
  for (int o = G >> 1; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if (own && t == 0) store(out, pass, k, p, keep);
}

}  // namespace

extern "C" {

// out (n,) = the fused, masked gather-GEMV-scatter above, launched on
// `stream` of CUDA device `device`.  Any m >= 1; path 0 picks the kernel
// by m, 1 forces the pair kernel (m even in [2, 64], A 16-byte and gidx
// 8-byte aligned), 2 the strided one.  out_mask and pass are both null or
// both set.  The strided
// kernel's tables (alfi_torch/kernels.py builds them): slot_cols, the
// live extent of each slot's block, and glog, log2 of its lanes per dof
// (0..5).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
int alfi_gather_gemv_scatter(const double* A, const double* x,
                             const int* gidx, const int* offsets,
                             const int* slots,
                             const unsigned char* out_mask,
                             const double* pass, double* out, int n, int m,
                             int path, int device, void* stream,
                             const int* slot_cols, int glog) {
  if (n < 0 || m < 1 || path < 0 || path > 2 || glog < 0 || glog > 5 ||
      (out_mask == nullptr) != (pass == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool pair_ok = m <= kMaxM && m % 2 == 0 &&
                       reinterpret_cast<unsigned long long>(A) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(gidx) % 8 == 0;
  if (path == 1 && !pair_ok) return (int)cudaErrorInvalidValue;
  const bool pair = path == 1 || (path == 0 && pair_ok);
  if (n == 0) return (int)cudaSuccess;
  if (pair) {
    // lanes per dof: one per column pair
    glog = 0;
    while (glog < 5 && (1 << glog) < m / 2) ++glog;
  }
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
        A, x, gidx, offsets, slots, slot_cols, out_mask, pass, out, n, m,
        glog);
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

}  // extern "C"
