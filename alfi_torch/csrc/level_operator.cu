// The merged level operator of the almg cycle on Hopper: its apply (KM),
// its assembly (KA), and the gamma-split grad-div term (KB) of the
// mixed-precision modes.
//
// The level operator is  out = mask * A (mask * x) + (1 - mask) * x  with
// A = sum_c R_c^T T_c R_c + sum_f R_f^T F_f R_f: per-cell element tensors
// T_c and, with Burman's stabilisation, per-interior-facet Jacobians F_f,
// both rebuilt once per Newton step.  Replaces the level apply of the JAX
// package, alfi_tpu/mg/velocity.py:VelocityMG.level_apply: its batch-major
// cell branch (:437-440) and its facet branch (:449-454), plain XLA, no
// Pallas kernel.  Before this source the port streamed the blocks
// themselves every apply (K2 over the cells, then KF over the facets, in
// gather_gemv_scatter.cu).  But the blocks repeat each coupling: at the
// Scott-Vogelius levels 6.6x (2D) and 9.9x (3D), since a dof of a facet
// block stands in every facet of every cell around it; 1.6-1.8x on the
// cell tables alone.  So once per level and Newton step KA sums the blocks
// into one operator of distinct couplings, and every apply of that step
// (about 118 per Newton step at the 3D SV level) reads that with KM.
//
// Layout (alfi_torch/mg/level_operator.py builds it on the host, once per
// level): BSR over the nodes of the level, d x d blocks (d = 2, 3), block
// b at vals[b*d*d .. (b+1)*d*d) row-major, block columns ascending per
// row, int32 rowptr and bcol.  The BC mask is folded in: an entry whose
// row or column is masked stays 0, a block with no live entry is not
// stored, and a masked output component takes x (keep[k] == 0).
//
// KM, level_apply_kernel.
//   * What bounds it: bytes.  Each value is used for one multiply-add, 1/8
//     flop per byte.  One apply reads the blocks (8 d^2 B each) and their
//     column index (4 B: 76 B per 9 entries in 3D, 36 B per 4 in 2D,
//     against CSR's 12 B per entry), rowptr, x and keep, and writes out.
//   * Design: a group of G lanes per node row, G = 2^glog from the rows'
//     lengths and the block size (alfi_torch/kernels.py:
//     merged_lanes_log2).  Lane t takes
//     the row's blocks t, t + G, ... in ascending order, two to a step so
//     that two blocks' loads are in flight, and loads each block whole: the
//     d^2 values (72 contiguous bytes in 3D, so adjacent lanes read one
//     contiguous span) and the d values of x at its column node through
//     the read-only path (x is 2.1 MB at the largest level and stays in
//     L2).  No tensor cores and no TMA: the work is 1/8 flop per byte.
//   * Summation order (deterministic, no atomics: two launches give the
//     same bits): lane t keeps d f64 partials, one per row component i,
//     each updated with fma over j = 0 .. d-1 of each of its blocks in
//     ascending order; then the G partials of each component are added by
//     an xor butterfly (offsets G/2, ..., 1), which gives every lane the
//     same bits since f64 addition commutes exactly; lane i % G writes
//     component i.
//
// KA, level_assemble_kernel.
//   * vals[e] = sum over s in [amap_ptr[e], amap_ptr[e+1]) of src[s], with
//     src the cell tensors for a position below ncell and the facet
//     tensors (position - ncell) above: the two are never concatenated.
//     One thread per merged entry, plain adds (__dadd_rn, nothing to fuse)
//     in the map's order, cells then facets, each ascending; no atomics,
//     so the bits repeat.  index_add_ on the card would use atomics.
//   * What bounds it: bytes, each block entry read once (8 B) with its map
//     entry (4 B), and vals written once.  Adjacent threads take adjacent
//     entries of a block, whose sources in one cell or facet tensor are
//     adjacent too.
//
// KM in mixed precision (alfi_torch/config.py): level_apply_kernel is a
// template on the value type TV and the vector type TX, double or float,
// and accumulates in the promoted type (double unless both are float),
// the JAX package's promotion, storing out in TX.  Three modes besides
// f64: (f64 values, f32 vectors) for the defect-correction smoother,
// whose inner Krylov loop applies the f64 operator to f32 vectors; (f32
// values, f64 vectors) for mg_store, f32 storage with f64 arithmetic;
// (f32, f32) for the f32 cycle.  f32 values halve the bytes of the
// stream, which bounds KM.
//
// KB, the gamma-split grad-div term.  In the split modes the merged
// values hold only the gamma-free part M (nu K + advect N, and the
// stabilisation's terms), and the augmented-Lagrangian term is applied
// through its static per-cell factors B_c (nc, nld, q), with G_c = B_c
// B_c^T, in f64:
//
//   out = y + keep * gamma * sum_c R_c^T B_c (B_c^T R_c (keep * x))
//
// with x, y and out in the vector type.  Storing gamma G in f32 would round
// the gamma part at gamma * eps32 absolute, which buries the viscous part
// on nearly divergence-free fields; the f64 dot cancels where the term
// does.  Replaces the JAX package's gamma-split dict branch of level_apply
// (alfi_tpu/mg/velocity.py:417-431) and the Schoeberl transfer's
// _apply_gd (alfi_tpu/mg/schoeberl.py:128-140), plain XLA.
//   * Cell stage (graddiv_cell_kernel), in f64:
//       dq[c, p] = gamma * sum_i B[c, i, p] * x[gidx[c, i]]  (i ascending,
//                  fma; a masked or pad entry (-1) reads 0),
//       w[c, i]  = sum_p B[c, i, p] * dq[c, p]              (p ascending,
//                  fma from 0; for q = 1 the product, rounded once),
//     the cells' contributions, written in cell order (coalesced).  A
//     group of G lanes per cell (G the power of two >= nld / 2, 4 .. 32:
//     32 for the 3D nld = 42, 8 for the 2D nld = 12), C = 256 / G cells
//     a block: the lanes gather the cell's x values and load its B rows
//     together, into shared memory; one thread per (cell, p) takes dq's
//     sum from there in ascending i; then each lane writes its rows' w.
//     The one-thread-per-(cell, p) design before it walked nld = 42
//     dependent gidx -> x loads: a latency chain of about 20 us at any
//     cell count (3D L1, 3,072 cells: 20.9 us for both stages; L2,
//     24,576: 25.1 us), on a grid that filled 12 of the 132 SMs at L1.
//     Here a lane issues at most two gathers.  (Writing w in the dof
//     stage's order instead, for contiguous reads there, scatters the
//     writes: at the 3D L2 table the cell stage then took twice as long.)
//   * Dof stage: out[k] = y[k] + the sum over k's CSR list of (cell, slot)
//     positions s = c * nld + i, ascending, of w[s], plain f64 adds from
//     0, rounded once to the vector type: the plain version's order
//     (fem/scatter.py:ScatterAdd over the entries in ascending position).
//     The list is read kDofBatch entries at a time, their positions and
//     then their w loaded together, so a list of 24 (a 3D vertex) is
//     three rounds of two dependent loads.  A masked dof has an empty
//     list.  No atomics: two launches give the same bits.
//       - In a split level apply whose KM rows are narrow, at most 4 d
//         lanes a row (the 2D levels: 8 lanes), it is KM's epilogue
//         (level_apply_kernel with w and the lists): the lane that writes
//         component i of node r adds dof (r, i)'s sum to its promoted
//         accumulator after the row's blocks, so the apply is two
//         launches (cell stage, KM) where it was three.  In store32 (f32
//         values, f64 vectors) and in the f32 cycle (f32 values and
//         vectors) the accumulator's type is the vector type, so out
//         rounds as y + sum did; with f64 values on f32 vectors (level
//         operators kept f64 in the f32 cycle) y is no longer rounded to
//         f32 before the sum.  On wide rows (3D: 16 or 32 lanes) only d of
//         them would walk the lists while the rest wait, and the card
//         measured the epilogue slower there than a launch of its own
//         (PERF.md section 6): those levels keep three launches.
//       - Otherwise, and for the raw use (the Schoeberl transfer's
//         operator, no KM), it runs as graddiv_dof_kernel, one thread per
//         dof, after the cell stage.
//   * What bounds it: bytes.  B is read once, each entry for two
//     multiply-adds, and w is written and read once.  At the 2D fine
//     level of the bench config B is 8,192 x 12 x 1 f64, 0.8 MB, against
//     KM's 6.6 MB of values: the split keeps most of the f32 saving.
//
// Measured on the card: PERF.md section 6 (chip_smoke.py phases 3b and
// 20).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// the accumulation type of a value type and a vector type: double unless
// both are float
template <typename TV, typename TX>
struct Acc {
  using type = double;
};
template <>
struct Acc<float, float> {
  using type = float;
};

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

// the dof stage's sum for flat dof k: w at its list's positions,
// ascending, plain f64 adds from 0; kDofBatch positions, then their w,
// loaded together
constexpr int kDofBatch = 8;

__device__ __forceinline__ double graddiv_dof_sum(
    const double* __restrict__ w, const int* __restrict__ offsets,
    const int* __restrict__ slots, long long k) {
  double acc = 0.0;
  const int uend = __ldg(offsets + k + 1);
  for (int u = __ldg(offsets + k); u < uend; u += kDofBatch) {
    const int nb = min(kDofBatch, uend - u);
    int s[kDofBatch];
    double v[kDofBatch];
#pragma unroll
    for (int j = 0; j < kDofBatch; ++j)
      s[j] = j < nb ? __ldg(slots + u + j) : 0;
#pragma unroll
    for (int j = 0; j < kDofBatch; ++j) v[j] = j < nb ? __ldg(w + s[j]) : 0.0;
#pragma unroll
    for (int j = 0; j < kDofBatch; ++j)
      if (j < nb) acc += v[j];
  }
  return acc;
}

// One block's d x d values and the d values of x at its column node.
template <int D, typename TV, typename TX>
struct Block {
  TV a[D * D];
  TX xv[D];

  __device__ __forceinline__ void load(const TV* __restrict__ vals,
                                       const TX* __restrict__ x,
                                       const int* __restrict__ bcol, int q) {
    const long long c = __ldg(bcol + q);
    const TV* __restrict__ v = vals + (long long)q * (D * D);
#pragma unroll
    for (int e = 0; e < D * D; ++e) a[e] = __ldg(v + e);
#pragma unroll
    for (int j = 0; j < D; ++j) xv[j] = __ldg(x + c * D + j);
  }

  // p[i] += sum_j a[i][j] x[j], j ascending, in the accumulation type
  template <typename TA>
  __device__ __forceinline__ void add(TA* p) const {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j)
        p[i] = fma_t((TA)a[i * D + j], (TA)xv[j], p[i]);
  }
};

// The grad-div epilogue's tables (KB's dof stage, see the header note):
// all null but for a split level apply.
struct GradDivTables {
  const double* w;
  const int* offsets;
  const int* slots;
};

template <int D, typename TV, typename TX, bool GD>
__global__ void __launch_bounds__(kThreads)
level_apply_kernel(const TV* __restrict__ vals,
                   const TX* __restrict__ x,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ bcol,
                   const unsigned char* __restrict__ keep,
                   TX* __restrict__ out, int nodes, int glog,
                   GradDivTables gd) {
  using TA = typename Acc<TV, TX>::type;
  const int G = 1 << glog;
  const long long r =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> glog;
  const int t = threadIdx.x & (G - 1);
  const bool own = r < nodes;
  TA p[D];
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = TA(0);
  if (own) {
    const int qend = rowptr[r + 1];
    int q = rowptr[r] + t;
    // two blocks to a step, added in ascending order
    for (; q + G < qend; q += 2 * G) {
      Block<D, TV, TX> b0, b1;
      b0.load(vals, x, bcol, q);
      b1.load(vals, x, bcol, q + G);
      b0.add(p);
      b1.add(p);
    }
    if (q < qend) {
      Block<D, TV, TX> b0;
      b0.load(vals, x, bcol, q);
      b0.add(p);
    }
  }
  // every lane of the warp reaches this point (no early return), so the
  // full-warp shuffles are safe; offsets < G stay inside the group
  for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], o);
  }
  if (own) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      if ((i & (G - 1)) == t) {
        const long long k = r * D + i;
        if (!GD) {
          out[k] = keep[k] ? (TX)p[i] : x[k];
        } else {
          // the grad-div sum in list order, loaded after the row's blocks
          // (held across them, its registers cost the row's loads
          // occupancy), then one rounding of the promoted sum plus it
          out[k] = keep[k] ? (TX)((double)p[i]
                                  + graddiv_dof_sum(gd.w, gd.offsets,
                                                    gd.slots, k))
                           : x[k];
        }
      }
  }
}

__global__ void __launch_bounds__(kThreads)
level_assemble_kernel(const double* __restrict__ cells,
                      const double* __restrict__ facets, int ncell,
                      const int* __restrict__ amap_ptr,
                      const int* __restrict__ amap_src,
                      double* __restrict__ vals, long long nvals) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= nvals) return;
  double acc = 0.0;
  const int s1 = amap_ptr[e + 1];
  for (int s = amap_ptr[e]; s < s1; ++s) {
    const int q = __ldg(amap_src + s);
    acc = __dadd_rn(acc, q < ncell ? __ldg(cells + q)
                                   : __ldg(facets + (q - ncell)));
  }
  vals[e] = acc;
}

// KB cell stage: dq[c, p] = gamma * sum_i B[c, i, p] x[gidx[c, i]] and
// w[c * nld + i] = sum_p B[c, i, p] dq[c, p] (see the header note), 2^glog
// lanes per cell staging x, B and dq in shared memory (C * (nld * (1 + q)
// + q) doubles), one thread per (cell, p) for the ordered sum.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
graddiv_cell_kernel(const double* __restrict__ B, const TX* __restrict__ x,
                    const int* __restrict__ gidx, double* __restrict__ w,
                    int nc, int nld, int q, double gamma, int glog) {
  extern __shared__ double stage[];
  const int G = 1 << glog;
  const int C = kThreads >> glog;
  const int cl = threadIdx.x >> glog;
  const int t = threadIdx.x & (G - 1);
  const long long c0 = (long long)blockIdx.x * C;
  const long long c = c0 + cl;
  double* __restrict__ sx = stage;
  double* __restrict__ sb = stage + C * nld;
  double* __restrict__ sdq = sb + C * nld * q;
  if (c < nc) {
    const int* __restrict__ g = gidx + c * nld;
    for (int i = t; i < nld; i += G) {
      const int gi = __ldg(g + i);
      sx[cl * nld + i] = gi >= 0 ? (double)__ldg(x + gi) : 0.0;
    }
    const double* __restrict__ b = B + c * nld * q;
    for (int e = t; e < nld * q; e += G) sb[cl * nld * q + e] = __ldg(b + e);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < C * q; v += kThreads) {
    const int vc = v / q;
    const int p = v - vc * q;
    if (c0 + vc >= nc) break;
    const double* __restrict__ xs = sx + vc * nld;
    const double* __restrict__ bs = sb + vc * nld * q + p;
    double acc = 0.0;
#pragma unroll 8
    for (int i = 0; i < nld; ++i) acc = fma(bs[i * q], xs[i], acc);
    sdq[v] = gamma * acc;
  }
  __syncthreads();
  if (c < nc) {
    for (int i = t; i < nld; i += G) {
      const double* __restrict__ bs = sb + (cl * nld + i) * q;
      double acc = 0.0;
      for (int p = 0; p < q; ++p) acc = fma(bs[p], sdq[cl * q + p], acc);
      w[c * nld + i] = acc;
    }
  }
}

// KB dof stage of the raw use: out[k] = y[k] + graddiv_dof_sum(k); y
// may be null (0).
template <typename TX>
__global__ void __launch_bounds__(kThreads)
graddiv_dof_kernel(const double* __restrict__ w,
                   const int* __restrict__ offsets,
                   const int* __restrict__ slots, const TX* y, TX* out,
                   int n) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const double acc = graddiv_dof_sum(w, offsets, slots, k);
  out[k] = (TX)((y == nullptr ? 0.0 : (double)y[k]) + acc);
}

// Run the launch on `device`, restoring the caller's current device; the
// launch's own refusal (an int) or else cudaGetLastError() after it.
template <typename F>
int on_device(int device, F launch) {
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  int err = 0;
  if constexpr (std::is_same_v<decltype(launch()), int>) err = launch();
  else launch();
  if (err == 0) err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

template <int D, typename TV, typename TX>
void apply(const void* vals, const void* x, const int* rowptr,
           const int* bcol, const unsigned char* keep, void* out, int nodes,
           int glog, const GradDivTables& gd, unsigned grid, void* stream) {
  if (gd.w == nullptr)
    level_apply_kernel<D, TV, TX, false>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const TV*)vals, (const TX*)x, rowptr, bcol, keep, (TX*)out,
            nodes, glog, gd);
  else
    level_apply_kernel<D, TV, TX, true>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const TV*)vals, (const TX*)x, rowptr, bcol, keep, (TX*)out,
            nodes, glog, gd);
}

template <int D>
void apply_types(int types, const void* vals, const void* x,
                 const int* rowptr, const int* bcol,
                 const unsigned char* keep, void* out, int nodes, int glog,
                 const GradDivTables& gd, unsigned grid, void* stream) {
  switch (types) {
    case 0:
      apply<D, double, double>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                               gd, grid, stream);
      break;
    case 1:
      apply<D, float, double>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                              gd, grid, stream);
      break;
    case 2:
      apply<D, double, float>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                              gd, grid, stream);
      break;
    default:
      apply<D, float, float>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                             gd, grid, stream);
  }
}

// the cell stage's lanes per cell: the power of two >= nld / 2, 4 .. 32
int graddiv_cell_glog(int nld) {
  int glog = 2;
  while (glog < 5 && (2 << glog) < nld) ++glog;
  return glog;
}

// the cell stage's launch; cudaErrorInvalidValue when its shared memory
// would pass 48 KB
template <typename TX>
int graddiv_cells(const double* B, const void* x, const int* gidx,
                  double* w, int nc, int nld, int q, double gamma,
                  void* stream) {
  const int glog = graddiv_cell_glog(nld);
  const int C = kThreads >> glog;
  const size_t smem = sizeof(double) * (size_t)C * (nld * (1 + q) + q);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (nc > 0)
    graddiv_cell_kernel<TX>
        <<<(unsigned)(((long long)nc + C - 1) / C), kThreads, smem,
           (cudaStream_t)stream>>>(B, (const TX*)x, gidx, w, nc, nld, q,
                                   gamma, glog);
  return (int)cudaSuccess;
}

template <typename TX>
int graddiv(const double* B, const void* x, const int* gidx,
            const int* offsets, const int* slots, const void* y, void* out,
            double* w, int nc, int nld, int q, int n, double gamma,
            void* stream) {
  const int err = graddiv_cells<TX>(B, x, gidx, w, nc, nld, q, gamma,
                                    stream);
  if (err != (int)cudaSuccess) return err;
  graddiv_dof_kernel<TX>
      <<<(unsigned)(((long long)n + kThreads - 1) / kThreads), kThreads, 0,
         (cudaStream_t)stream>>>(w, offsets, slots, (const TX*)y, (TX*)out,
                                 n);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// KM: out (nodes * d,) = keep ? A x : x over the BSR (vals, rowptr, bcol)
// of d x d blocks, d = 2 or 3, with 2^glog lanes per node row (glog in
// 0..5), on `stream` of CUDA device `device`.  `types`: bit 0 set for f32
// values, bit 1 for f32 vectors (x and out); 0 is all f64.  With gd_w set,
// the grad-div epilogue (KB's dof stage): gd_w the cell stage's
// contributions (alfi_graddiv_cells), gd_offsets and gd_slots KB's CSR
// lists; kept dofs take (TX)(A x + the sum of their list) in one
// rounding.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
int alfi_level_apply(const void* vals, const void* x, const int* rowptr,
                     const int* bcol, const unsigned char* keep, void* out,
                     int nodes, int d, int glog, int device, void* stream,
                     int types, const double* gd_w, const int* gd_offsets,
                     const int* gd_slots) {
  if (nodes < 0 || (d != 2 && d != 3) || glog < 0 || glog > 5 ||
      types < 0 || types > 3 ||
      (gd_w != nullptr && (gd_offsets == nullptr || gd_slots == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (nodes == 0) return (int)cudaSuccess;
  const GradDivTables gd{gd_w, gd_offsets, gd_slots};
  const long long threads = (long long)nodes << glog;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  return on_device(device, [&] {
    if (d == 2)
      apply_types<2>(types, vals, x, rowptr, bcol, keep, out, nodes, glog,
                     gd, grid, stream);
    else
      apply_types<3>(types, vals, x, rowptr, bcol, keep, out, nodes, glog,
                     gd, grid, stream);
  });
}

// KA: vals (nvals,) = the assembly map's sums over [cells ‖ facets]
// (facets may be null when no position reaches ncell).  Returns
// cudaGetLastError() after the launch.
int alfi_level_assemble(const double* cells, const double* facets,
                        int ncell, const int* amap_ptr, const int* amap_src,
                        double* vals, long long nvals, int device,
                        void* stream) {
  if (nvals < 0 || ncell < 0) return (int)cudaErrorInvalidValue;
  if (nvals == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((nvals + kThreads - 1) / kThreads);
  return on_device(device, [&] {
    level_assemble_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        cells, facets, ncell, amap_ptr, amap_src, vals, nvals);
  });
}

// KB, the raw use: out (n,) = y + keep * gamma * sum_c R_c^T B_c (B_c^T
// R_c (keep * x)) (see the header note), B (nc, nld, q) f64; gidx (nc,
// nld), the cells' dofs with masked ones -1; offsets (n + 1,), slots: per
// dof the positions c * nld + i that own it, ascending (none for a
// masked dof); w: f64 scratch of nc * nld; y null for 0, or y == out (in
// place).  x_f32: x, y and out f32 (else f64).  Two launches on `stream`
// (the cell and the dof stage); returns cudaGetLastError() after them.
int alfi_graddiv_apply(const double* B, const void* x, const int* gidx,
                       const int* offsets, const int* slots, const void* y,
                       void* out, double* w, int nc, int nld, int q, int n,
                       double gamma, int x_f32, int device, void* stream) {
  if (nc < 0 || nld < 1 || q < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    return x_f32 ? graddiv<float>(B, x, gidx, offsets, slots, y, out, w, nc,
                                  nld, q, n, gamma, stream)
                 : graddiv<double>(B, x, gidx, offsets, slots, y, out, w, nc,
                                   nld, q, n, gamma, stream);
  });
}

// KB's cell stage alone, for a split level apply whose dof stage is KM's
// epilogue: w (nc * nld,) f64 as above.  One launch; returns
// cudaGetLastError() after it.
int alfi_graddiv_cells(const double* B, const void* x, const int* gidx,
                       double* w, int nc, int nld, int q, double gamma,
                       int x_f32, int device, void* stream) {
  if (nc < 0 || nld < 1 || q < 1) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    return x_f32 ? graddiv_cells<float>(B, x, gidx, w, nc, nld, q, gamma,
                                        stream)
                 : graddiv_cells<double>(B, x, gidx, w, nc, nld, q, gamma,
                                         stream);
  });
}

}  // extern "C"
