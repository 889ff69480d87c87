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
// KB, the gamma-split grad-div term (graddiv_cell_kernel, then
// graddiv_dof_kernel).  In the split modes the merged values hold only
// the gamma-free part M (nu K + advect N, and the stabilisation's terms),
// and the augmented-Lagrangian term is applied through its static
// per-cell factors B_c (nc, nld, q), with G_c = B_c B_c^T, in f64:
//
//   out = y + keep * gamma * sum_c R_c^T B_c (B_c^T R_c (keep * x))
//
// with x, y and out in the vector type.  Storing gamma G in f32 would round
// the gamma part at gamma * eps32 absolute, which buries the viscous part
// on nearly divergence-free fields; the f64 dot cancels where the term
// does.  Replaces the JAX package's gamma-split dict branch of level_apply
// (alfi_tpu/mg/velocity.py:417-431) and the Schoeberl transfer's
// _apply_gd (alfi_tpu/mg/schoeberl.py:128-140), plain XLA.
//   * Stage 1, one thread per (cell, factor column p):
//     dq[c, p] = gamma * sum_i B[c, i, p] * x[gidx[c, i]], i ascending, f64
//     fma; a masked or pad entry (-1) reads 0.
//   * Stage 2, one thread per output dof k: the sum over k's CSR list of
//     (cell, slot) positions s = c * nld + i, ascending, and p ascending,
//     of B[c, i, p] * dq[c, p] (f64 fma), then out[k] = y[k] + that, in f64
//     and rounded once to TX.  A masked dof has an empty list.  No atomics:
//     two launches give the same bits.
//   * Two launches, not an epilogue of KM: the dof stage needs every dq
//     of the cells around a dof, which other threads compute, and a
//     separate stage keeps KB testable alone; stage 2 reads KM's output
//     and writes it in place (one read and one write of n values).
//   * What bounds it: bytes.  B is read twice (each stage once; the bound
//     counts it once), each entry for one multiply-add.  At the 2D fine
//     level of the bench config B is 8,192 x 12 x 1 f64, 0.8 MB, against
//     KM's 6.6 MB of values: the split keeps most of the f32 saving.
//
// Measured on the card: PERF.md section 6 (chip_smoke.py phases 3b and
// 20).

#include <cuda_runtime.h>

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

template <int D, typename TV, typename TX>
__global__ void __launch_bounds__(kThreads)
level_apply_kernel(const TV* __restrict__ vals,
                   const TX* __restrict__ x,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ bcol,
                   const unsigned char* __restrict__ keep,
                   TX* __restrict__ out, int nodes, int glog) {
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
        out[k] = keep[k] ? (TX)p[i] : x[k];
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

// KB stage 1: dq[c * q + p] = gamma * sum_i B[c, i, p] x[gidx[c, i]].
template <typename TX>
__global__ void __launch_bounds__(kThreads)
graddiv_cell_kernel(const double* __restrict__ B, const TX* __restrict__ x,
                    const int* __restrict__ gidx, double* __restrict__ dq,
                    int nc, int nld, int q, double gamma) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)nc * q) return;
  const long long c = t / q;
  const int p = (int)(t - c * q);
  const double* __restrict__ b = B + c * nld * q + p;
  const int* __restrict__ g = gidx + c * nld;
  double acc = 0.0;
  for (int i = 0; i < nld; ++i) {
    const int gi = __ldg(g + i);
    acc = fma(__ldg(b + (long long)i * q), gi >= 0 ? (double)__ldg(x + gi)
                                                   : 0.0, acc);
  }
  dq[t] = gamma * acc;
}

// KB stage 2: out[k] = y[k] + sum over k's slots s, ascending, and p of
// B[s * q + p] dq[(s / nld) * q + p]; y may be null (0).
template <typename TX>
__global__ void __launch_bounds__(kThreads)
graddiv_dof_kernel(const double* __restrict__ B,
                   const double* __restrict__ dq,
                   const int* __restrict__ offsets,
                   const int* __restrict__ slots, const TX* y,
                   TX* out, int n, int nld, int q) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  double acc = 0.0;
  const int qend = offsets[k + 1];
  for (int u = offsets[k]; u < qend; ++u) {
    const long long s = __ldg(slots + u);
    const double* __restrict__ b = B + s * q;
    const double* __restrict__ d = dq + (s / nld) * q;
    for (int p = 0; p < q; ++p) acc = fma(__ldg(b + p), __ldg(d + p), acc);
  }
  out[k] = (TX)((y == nullptr ? 0.0 : (double)y[k]) + acc);
}

// Run the launch on `device`, restoring the caller's current device.
template <typename F>
int on_device(int device, F launch) {
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  launch();
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

template <int D, typename TV, typename TX>
void apply(const void* vals, const void* x, const int* rowptr,
           const int* bcol, const unsigned char* keep, void* out, int nodes,
           int glog, unsigned grid, void* stream) {
  level_apply_kernel<D, TV, TX><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const TV*)vals, (const TX*)x, rowptr, bcol, keep, (TX*)out, nodes,
      glog);
}

template <int D>
void apply_types(int types, const void* vals, const void* x,
                 const int* rowptr, const int* bcol,
                 const unsigned char* keep, void* out, int nodes, int glog,
                 unsigned grid, void* stream) {
  switch (types) {
    case 0:
      apply<D, double, double>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                               grid, stream);
      break;
    case 1:
      apply<D, float, double>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                              grid, stream);
      break;
    case 2:
      apply<D, double, float>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                              grid, stream);
      break;
    default:
      apply<D, float, float>(vals, x, rowptr, bcol, keep, out, nodes, glog,
                             grid, stream);
  }
}

template <typename TX>
void graddiv(const double* B, const void* x, const int* gidx,
             const int* offsets, const int* slots, const void* y, void* out,
             double* dq, int nc, int nld, int q, int n, double gamma,
             void* stream) {
  const long long cells = (long long)nc * q;
  if (cells > 0)
    graddiv_cell_kernel<TX>
        <<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>(B, (const TX*)x, gidx, dq, nc, nld, q,
                                   gamma);
  graddiv_dof_kernel<TX>
      <<<(unsigned)(((long long)n + kThreads - 1) / kThreads), kThreads, 0,
         (cudaStream_t)stream>>>(B, dq, offsets, slots, (const TX*)y,
                                 (TX*)out, n, nld, q);
}

}  // namespace

extern "C" {

// KM: out (nodes * d,) = keep ? A x : x over the BSR (vals, rowptr, bcol)
// of d x d blocks, d = 2 or 3, with 2^glog lanes per node row (glog in
// 0..5), on `stream` of CUDA device `device`.  `types`: bit 0 set for f32
// values, bit 1 for f32 vectors (x and out); 0 is all f64.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments it does not take).
int alfi_level_apply(const void* vals, const void* x, const int* rowptr,
                     const int* bcol, const unsigned char* keep, void* out,
                     int nodes, int d, int glog, int device, void* stream,
                     int types) {
  if (nodes < 0 || (d != 2 && d != 3) || glog < 0 || glog > 5 ||
      types < 0 || types > 3)
    return (int)cudaErrorInvalidValue;
  if (nodes == 0) return (int)cudaSuccess;
  const long long threads = (long long)nodes << glog;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  return on_device(device, [&] {
    if (d == 2)
      apply_types<2>(types, vals, x, rowptr, bcol, keep, out, nodes, glog,
                     grid, stream);
    else
      apply_types<3>(types, vals, x, rowptr, bcol, keep, out, nodes, glog,
                     grid, stream);
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

// KB: out (n,) = y + keep * gamma * sum_c R_c^T B_c (B_c^T R_c (keep * x))
// (see the header note), B (nc, nld, q) f64; gidx (nc, nld), the cells'
// dofs with masked ones -1; offsets (n + 1,), slots: per dof the
// positions c * nld + i that own it, ascending (none for a masked dof);
// dq: f64 scratch of nc * q; y null for 0, or y == out (in place).
// x_f32: x, y and out f32 (else f64).  Two launches on `stream`; returns
// cudaGetLastError() after them.
int alfi_graddiv_apply(const double* B, const void* x, const int* gidx,
                       const int* offsets, const int* slots, const void* y,
                       void* out, double* dq, int nc, int nld, int q, int n,
                       double gamma, int x_f32, int device, void* stream) {
  if (nc < 0 || nld < 1 || q < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    if (x_f32)
      graddiv<float>(B, x, gidx, offsets, slots, y, out, dq, nc, nld, q, n,
                     gamma, stream);
    else
      graddiv<double>(B, x, gidx, offsets, slots, y, out, dq, nc, nld, q, n,
                      gamma, stream);
  });
}

}  // extern "C"
