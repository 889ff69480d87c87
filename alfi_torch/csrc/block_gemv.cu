// Batched gather-GEMV-scatter for the AL multigrid cycle, in f64 on Hopper.
//
//     y = sum_b S_b^T A_b S_b x        (A_b dense m x m, S_b a 0/1 gather)
//
// as two kernels with a plain C interface (bound by ctypes from
// alfi_torch/kernels.py, which checks every argument first):
//
//   gather_bgemv     Y[b, i] = sum_j A[b, i, j] * x[idx[b, j]]
//                    (an idx entry outside [0, n) reads 0)
//   csr_segment_sum  out[k] = sum of Y.flat[t] over the CSR list of the
//                    (b, i) slots that own dof k, in the list's order
//
// Uses on the almg main path:
//   K1  patch apply: A_b = explicit patch inverses, idx = PatchSet.dofs.
//       Replaces the TPU kernel alfi_tpu/solvers/patch_pallas.py
//       _gemv_kernel / apply_transposed_pallas (deleted in aaee1ce; read
//       it with `git show aaee1ce^:alfi_tpu/solvers/patch_pallas.py`),
//       whose job is today done by solvers/batched_lu.py:182,284 inside
//       mg/patches.py:728-730 (smoother and Schoeberl patch solves).
//   K2  level matvec: A_b = per-cell element tensors, idx = MGLevel.rows.
//       Replaces the plain-XLA batch-major branch of
//       alfi_tpu/mg/velocity.py:VelocityMG.level_apply (:437-440).
//
// What bounds it on the card: bytes.  Each A_b entry is read once and
// used for one multiply-add, so the GEMV is at 1/8 flop per byte, far
// below the f64 ridge point.  Counted from the shapes of the 2D bench
// config (ldc2d baseN=16, nref=2): one fine-level K1 apply streams
// 4,225 x 14 x 14 x 8 B = 6.6 MB of inverses and one fine-level K2 apply
// 8,192 x 12 x 12 x 8 B = 9.4 MB of element tensors; the gathered vector
// and the index tables add less than 1 MB.
//
// What the design does about it: A is streamed exactly once with
// coalesced loads.  A CTA owns T consecutive output rows, whose A rows
// are one contiguous span of T*m doubles; the CTA copies that span to
// shared memory with unit-stride loads, gathers the x values of the
// blocks those rows belong to once per CTA (not once per row), then each
// thread forms one row's dot product from shared memory in a fixed j
// order.  The scatter is a second, deterministic pass: no atomics, so
// every run adds in the same order and the iteration counts of a solve
// are reproducible run to run.  Fusing the two passes, wgmma/TMA and
// CUDA graphs are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 64;

__global__ void gather_bgemv_kernel(const double* __restrict__ A,
                                    const double* __restrict__ x,
                                    const int* __restrict__ idx,
                                    double* __restrict__ Y,
                                    long long nrows, int m, long long n) {
  extern __shared__ double smem[];
  const int T = blockDim.x;
  double* As = smem;                         // T * m: the CTA's A rows
  double* xs = smem + (long long)T * m;      // <= T + 2m gathered values
  const long long r0 = (long long)blockIdx.x * T;
  const long long rend = (r0 + T < nrows) ? r0 + T : nrows;
  const long long span = (rend - r0) * m;
  const double* Ab = A + r0 * m;
  for (long long t = threadIdx.x; t < span; t += T) As[t] = Ab[t];
  const long long b0 = r0 / m;
  const long long ne = ((rend - 1) / m - b0 + 1) * m;
  const int* ib = idx + b0 * m;
  for (long long t = threadIdx.x; t < ne; t += T) {
    const long long k = ib[t];
    xs[t] = (k >= 0 && k < n) ? x[k] : 0.0;
  }
  __syncthreads();
  const long long r = r0 + threadIdx.x;
  if (r < rend) {
    const double* a = As + (long long)threadIdx.x * m;
    const double* xb = xs + (r / m - b0) * m;
    double acc = 0.0;
    for (int j = 0; j < m; ++j) acc += a[j] * xb[j];
    Y[r] = acc;
  }
}

__global__ void csr_segment_sum_kernel(const double* __restrict__ vals,
                                       const int* __restrict__ offsets,
                                       const int* __restrict__ slots,
                                       double* __restrict__ out,
                                       long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int end = offsets[k + 1];
  double acc = 0.0;
  for (int t = offsets[k]; t < end; ++t) acc += vals[slots[t]];
  out[k] = acc;
}

}  // namespace

extern "C" {

// Y (nb, m) = batched gather-GEMV; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an m outside [1, 64]).
int alfi_gather_bgemv(const double* A, const double* x, const int* idx,
                      double* Y, long long nb, int m, long long n,
                      void* stream) {
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const long long nrows = nb * m;
  const int T = (m <= 32) ? 128 : 64;
  const size_t shmem = (size_t)((long long)T * m + T + 2 * m) * sizeof(double);
  const long long grid = (nrows + T - 1) / T;
  gather_bgemv_kernel<<<(unsigned)grid, T, shmem, (cudaStream_t)stream>>>(
      A, x, idx, Y, nrows, m, n);
  return (int)cudaGetLastError();
}

// out (n,) = CSR segment sums of vals; returns cudaGetLastError().
int alfi_csr_segment_sum(const double* vals, const int* offsets,
                         const int* slots, double* out, long long n,
                         void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = 256;
  const long long grid = (n + T - 1) / T;
  csr_segment_sum_kernel<<<(unsigned)grid, T, 0, (cudaStream_t)stream>>>(
      vals, offsets, slots, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
