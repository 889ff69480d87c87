// KL: the gathered batched LU solve of the Schoeberl transfer's patches in
// the f32 cycle, on Hopper.  For every patch p of the transfer's patch
// table, with the f64 LU factors of its matrix (partial pivoting) rounded
// to f32:
//
//   b        = x[gperm[p, :]]               (gather, rows interchanged)
//   solve L y = b                           (unit lower, forward)
//   solve U z = y                           (upper, backward)
//   out[sidx[p, i]] = z[i]                  (plain store, i < m)
//
// and out[k] = 0 for every dof k of the zero list (the dofs outside every
// patch).  Bound by ctypes from alfi_torch/kernels.py (PatchLUSolve builds
// the tables and checks every argument).
//
// Two uses, one kernel:
//   * the Schoeberl transfer's patch solve in the f32 cycle (factors,
//     vectors and arithmetic f32): the patches are disjoint in their dofs,
//     so sidx is the patch table and the store is the result;
//   * the additive patch smoother under the Chebyshev driver with its
//     factors stored in f32 (mg_smooth_dtype f32 in the grad-div harness,
//     the vectors f64): as the JAX package applies f32 LU factors to an
//     f64 vector (alfi_tpu/solvers/batched_lu.py:128-134, then the f64
//     sum of alfi_tpu/mg/patches.py:_gather_scatter), x is rounded to f32
//     at the gather and the solve runs in f32; the star patches overlap,
//     so sidx[p, i] = p * m + i stores every patch row to an f32 scratch
//     vector, and patch_slot_sum_kernel then sums each dof's rows in f64
//     over its CSR list (ascending), out-masked: out[k] = keep[k] ? sum :
//     pass[k].  Two launches, no atomics.
//
// What it replaces: the Schoeberl patch solve of the JAX package's f32
// cycle, alfi_tpu/mg/schoeberl.py:_patch_solve (:144-146) through
// alfi_tpu/mg/patches.py:build_patch_solver's apply, which on the CPU is
// jax.scipy.linalg.lu_solve on f32 factors (alfi_tpu/solvers/batched_lu.py
// _ScipyFactorization.solve, :128-134), cast there by
// alfi_tpu/mg/velocity.py:738-747; plain XLA, no Pallas kernel.  The port
// applied explicit inverses rounded to f32 (K1), whose entries of size
// 1/nu carry eps32/nu into a solution of size 1/gamma: one cycle at
// nu = 0.02 departed 6.1e-2 from f64, against the f32 LU factors' 9.7e-4.
// Triangular solves with f32 factors keep the LU's backward stability.
//
// Layout: the factors column-major per patch, lut[p, j, i] = LU[p, i, j]
// (m x m, L strictly below the diagonal, U on and above), so that the
// column j that a step reads is m contiguous floats.  gperm[p, i] =
// dofs[p, perm[p, i]], the gather index of row i after the row
// interchanges (-1 for a pad slot, which reads 0); sidx[p, i] = dofs[p, i]
// (-1 for a pad).  The Schoeberl patches are disjoint in their dofs (the
// interior dofs of one coarse cell, the coarse skeleton masked out), so
// the store is a plain write: no sum and no atomics.
//
// Design: a group of G lanes per patch, G the power of two >= m, at most
// 32 (8 for the 2D m = 6, 32 for the 3D m = 27 and the step's m = 24),
// so a warp carries 32 / G patches; lane t holds rows t, t + G, ... (R of
// them, R = ceil(m / G) <= 4) in registers.  Column j of the forward
// solve: the lane that holds y_j broadcasts it by a shuffle inside the
// group, and every lane updates its rows below j with one fma each from
// the column, which the group reads as one coalesced span.  The backward
// solve is the same from the last column, z_j = y_j / U_jj broadcast
// first.  Every row's updates run in ascending j (forward) and descending
// j (backward), the order of a column-oriented triangular solve; no
// atomics, so two launches give the same bits.
//
// Types: the solve is a template on the type TX of x, read and rounded
// to f32 at the gather; factors, arithmetic, rows and out are f32.  The
// sum is a template on out's type.
//
// What bounds it: bytes.  The factors are read once (4 m^2 B a patch, 144
// B at m = 6: 0.29 MB at the bench config's level-2 table of 2,048
// patches), each entry for one multiply-add; the tables, x and out add
// 4 m B a patch each.  At 3.35 TB/s that is about 0.13 us at 2,048 x 6:
// the launch, about 2 us, sets the time of every table of the 2D path.
// The dependent chain of 2 m shuffle-fma steps (12 at m = 6) is short
// beside it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 4;


template <int R, typename TX>
__global__ void __launch_bounds__(kThreads)
patch_lu_solve_kernel(const float* __restrict__ lut,
                      const TX* __restrict__ x,
                      const int* __restrict__ gperm,
                      const int* __restrict__ sidx,
                      const int* __restrict__ zero_list,
                      float* __restrict__ out, int npatch, int m, int glog,
                      int nzero, int patch_blocks) {
  if ((int)blockIdx.x >= patch_blocks) {
    // the dofs outside every patch: out = 0
    const long long z =
        (long long)(blockIdx.x - patch_blocks) * kThreads + threadIdx.x;
    if (z < nzero) out[__ldg(zero_list + z)] = 0.0f;
    return;  // the whole block leaves: no shuffle below is reached
  }
  const int G = 1 << glog;
  const long long p =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> glog;
  const int t = threadIdx.x & (G - 1);
  const bool own = p < npatch;
  const float* __restrict__ f = lut + (own ? p : 0) * (long long)m * m;
  float b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t + r * G;
    const int g = own && i < m ? __ldg(gperm + p * m + i) : -1;
    b[r] = g >= 0 ? (float)__ldg(x + g) : 0.0f;
  }
  // forward: L y = b, L unit lower; column j updates the rows below it.
  // Every lane of the warp runs the same trip counts (m is one per
  // launch), so the full-warp shuffles are safe; width G keeps each
  // shuffle inside its patch's group.
#pragma unroll
  for (int jr = 0; jr < R; ++jr) {
    for (int jl = 0; jl < G; ++jl) {
      const int j = jr * G + jl;
      if (j >= m) break;
      const float yj = __shfl_sync(0xffffffffu, b[jr], jl, G);
      const float* __restrict__ col = f + (long long)j * m;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = t + r * G;
        if (own && i > j && i < m)
          b[r] = fmaf(-__ldg(col + i), yj, b[r]);
      }
    }
  }
  // backward: U z = y; z_j = y_j / U_jj, then column j updates the rows
  // above it
#pragma unroll
  for (int jr = R - 1; jr >= 0; --jr) {
    for (int jl = G - 1; jl >= 0; --jl) {
      const int j = jr * G + jl;
      if (j >= m) continue;
      const float* __restrict__ col = f + (long long)j * m;
      const float zj = __shfl_sync(0xffffffffu, b[jr], jl, G) /
                       (own ? __ldg(col + j) : 1.0f);
      if (t == jl) b[jr] = zj;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = t + r * G;
        if (own && i < j) b[r] = fmaf(-__ldg(col + i), zj, b[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t + r * G;
    if (own && i < m) {
      const int s = __ldg(sidx + p * m + i);
      if (s >= 0) out[s] = b[r];
    }
  }
}

// The overlapping use's second launch: out[k] = keep[k] ? sum over k's
// CSR slots u, ascending, of ys[slots[u]] in T : pass[k] (no keep: the
// sum).
template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_slot_sum_kernel(const float* __restrict__ ys,
                      const int* __restrict__ offsets,
                      const int* __restrict__ slots,
                      const unsigned char* __restrict__ keep,
                      const T* __restrict__ pass, T* __restrict__ out, int n) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  if (keep != nullptr && keep[k] == 0) {
    out[k] = pass[k];
    return;
  }
  T acc = T(0);
  const int uend = __ldg(offsets + k + 1);
  for (int u = __ldg(offsets + k); u < uend; ++u)
    acc += (T)__ldg(ys + __ldg(slots + u));
  out[k] = acc;
}

template <typename TX>
int launch(const float* lut, const TX* x, const int* gperm, const int* sidx,
           const int* zero_list, float* out, int npatch, int m, int nzero,
           int device, void* stream) {
  if (npatch < 0 || m < 1 || m > 32 * kMaxRows || nzero < 0)
    return (int)cudaErrorInvalidValue;
  int glog = 0;
  while (glog < 5 && (1 << glog) < m) ++glog;
  const int G = 1 << glog;
  const int R = (m + G - 1) / G;
  const long long threads = (long long)npatch << glog;
  const int patch_blocks = (int)((threads + kThreads - 1) / kThreads);
  const int zero_blocks = (nzero + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(patch_blocks + zero_blocks);
  if (grid == 0) return (int)cudaSuccess;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 1)
    patch_lu_solve_kernel<1, TX><<<grid, kThreads, 0, s>>>(
        lut, x, gperm, sidx, zero_list, out, npatch, m, glog, nzero,
        patch_blocks);
  else if (R == 2)
    patch_lu_solve_kernel<2, TX><<<grid, kThreads, 0, s>>>(
        lut, x, gperm, sidx, zero_list, out, npatch, m, glog, nzero,
        patch_blocks);
  else
    patch_lu_solve_kernel<kMaxRows, TX><<<grid, kThreads, 0, s>>>(
        lut, x, gperm, sidx, zero_list, out, npatch, m, glog, nzero,
        patch_blocks);
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

template <typename T>
int slot_sum(const float* ys, const int* offsets, const int* slots,
             const unsigned char* keep, const T* pass, T* out, int n,
             int device, void* stream) {
  if (n < 0 || (keep == nullptr) != (pass == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  patch_slot_sum_kernel<T>
      <<<(unsigned)(((long long)n + kThreads - 1) / kThreads), kThreads, 0,
         (cudaStream_t)stream>>>(ys, offsets, slots, keep, pass, out, n);
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

}  // namespace

extern "C" {

// KL: out = the gathered batched LU solve above, f32, on `stream` of CUDA
// device `device`: lut (npatch, m, m) column-major f32 factors, gperm and
// sidx (npatch, m) int32, zero_list (nzero,) int32.  m in [1, 128].
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments it does not take).
int alfi_patch_lu_solve(const float* lut, const float* x, const int* gperm,
                        const int* sidx, const int* zero_list, float* out,
                        int npatch, int m, int nzero, int device,
                        void* stream) {
  return launch<float>(lut, x, gperm, sidx, zero_list, out, npatch, m,
                       nzero, device, stream);
}

// The same on an f64 x, rounded to f32 at the gather (out f32).
int alfi_patch_lu_solve_x64(const float* lut, const double* x,
                            const int* gperm, const int* sidx,
                            const int* zero_list, float* out, int npatch,
                            int m, int nzero, int device, void* stream) {
  return launch<double>(lut, x, gperm, sidx, zero_list, out, npatch, m,
                        nzero, device, stream);
}

// The overlapping use's sum (see the header note) of the f32 rows ys into
// out (n,), f32 (out_f32) or f64, by the CSR lists (offsets (n + 1,),
// slots); keep and pass both null or both set.
int alfi_patch_slot_sum(const float* ys, const int* offsets, const int* slots,
                        const unsigned char* keep, const void* pass,
                        void* out, int n, int out_f32, int device,
                        void* stream) {
  return out_f32 ? slot_sum<float>(ys, offsets, slots, keep,
                                   (const float*)pass, (float*)out, n, device,
                                   stream)
                 : slot_sum<double>(ys, offsets, slots, keep,
                                    (const double*)pass, (double*)out, n,
                                    device, stream);
}

}  // extern "C"
