// The merged level operator of the almg cycle, in f64 on Hopper: its
// apply (KM) and its assembly (KA).
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
// Measured on the card: PERF.md section 6 (chip_smoke.py phase 3b).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One block's d x d values and the d values of x at its column node.
template <int D>
struct Block {
  double a[D * D];
  double xv[D];

  __device__ __forceinline__ void load(const double* __restrict__ vals,
                                       const double* __restrict__ x,
                                       const int* __restrict__ bcol, int q) {
    const long long c = __ldg(bcol + q);
    const double* __restrict__ v = vals + (long long)q * (D * D);
#pragma unroll
    for (int e = 0; e < D * D; ++e) a[e] = __ldg(v + e);
#pragma unroll
    for (int j = 0; j < D; ++j) xv[j] = __ldg(x + c * D + j);
  }

  // p[i] += sum_j a[i][j] x[j], j ascending
  __device__ __forceinline__ void add(double* p) const {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) p[i] = fma(a[i * D + j], xv[j], p[i]);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
level_apply_kernel(const double* __restrict__ vals,
                   const double* __restrict__ x,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ bcol,
                   const unsigned char* __restrict__ keep,
                   double* __restrict__ out, int nodes, int glog) {
  const int G = 1 << glog;
  const long long r =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> glog;
  const int t = threadIdx.x & (G - 1);
  const bool own = r < nodes;
  double p[D];
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = 0.0;
  if (own) {
    const int qend = rowptr[r + 1];
    int q = rowptr[r] + t;
    // two blocks to a step, added in ascending order
    for (; q + G < qend; q += 2 * G) {
      Block<D> b0, b1;
      b0.load(vals, x, bcol, q);
      b1.load(vals, x, bcol, q + G);
      b0.add(p);
      b1.add(p);
    }
    if (q < qend) {
      Block<D> b0;
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
        out[k] = keep[k] ? p[i] : x[k];
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

}  // namespace

extern "C" {

// KM: out (nodes * d,) = keep ? A x : x over the BSR (vals, rowptr, bcol)
// of d x d blocks, d = 2 or 3, with 2^glog lanes per node row (glog in
// 0..5), on `stream` of CUDA device `device`.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments it does not take).
int alfi_level_apply(const double* vals, const double* x, const int* rowptr,
                     const int* bcol, const unsigned char* keep, double* out,
                     int nodes, int d, int glog, int device, void* stream) {
  if (nodes < 0 || (d != 2 && d != 3) || glog < 0 || glog > 5)
    return (int)cudaErrorInvalidValue;
  if (nodes == 0) return (int)cudaSuccess;
  const long long threads = (long long)nodes << glog;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  return on_device(device, [&] {
    if (d == 2)
      level_apply_kernel<2><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          vals, x, rowptr, bcol, keep, out, nodes, glog);
    else
      level_apply_kernel<3><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          vals, x, rowptr, bcol, keep, out, nodes, glog);
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

}  // extern "C"
