// Inverses of the diagonal blocks of a lower-triangular matrix, for Hopper
// (sm_90a).  Built into a shared library with a plain C interface and bound
// with ctypes (limbo_tpu_torch/ops/chol.py).
//
// Replaces limbo_tpu/ops/chol.py: _tri_inv_panel (_tri_inv_kernel,
// _unrolled_lower_inv).
//
// The TPU kernel inverted one (256, 256) block per call, w rows at a time.
// One f32 block of that size is 256 KiB, above the 227 KB a Hopper block
// may use, so the port takes B = 128 and, since the diagonal blocks are
// independent, inverts all N/B of them in ONE launch: block b of the grid
// inverts diagonal block b.
//
// Bound on the H100: latency.  The bytes (the lower triangles in, the
// inverses out: ~7.8 MB at N = 10240, B = 128, ~2.3 us at 3.35 TB/s) and
// the ~B^3/3 flops per block are both tiny; what costs is the dependency
// chain of forward substitution, row r of X = L^{-1} needing rows < r.  The
// design keeps that chain in shared memory: the block's triangle and X
// (2 * B * B * 4 B = 128 KB at B = 128) stay resident, thread c owns column
// c of X and walks the rows in order, every lane of a warp reads the same
// L[r, k] (a shared-memory broadcast) and its own X[k, c] (conflict-free),
// and a warp starts its k loop at its first column, so almost no work is
// spent on the structural zeros above the diagonal.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;  // ops/chol.py TRI_INV_BLOCK

__global__ void __launch_bounds__(B)
tri_inv_panel_kernel(const float* __restrict__ L, int N,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  float* Ls = smem;          // (B, B) lower triangle, row-major, zero above
  float* Xs = smem + B * B;  // (B, B) inverse, column c owned by thread c
  const int blk = blockIdx.x;
  const float* Lb = L + (size_t)blk * B * N + (size_t)blk * B;
  for (int e = threadIdx.x; e < B * B; e += B) {
    int r = e / B, k = e % B;
    Ls[e] = (k <= r) ? Lb[(size_t)r * N + k] : 0.f;
  }
  const int c = threadIdx.x;
  for (int r = 0; r < B; ++r) Xs[r * B + c] = 0.f;
  __syncthreads();

  // X[r, c] = ([r == c] - sum_{k < r} L[r, k] X[k, c]) / L[r, r]; X[k, c]
  // is zero for k < c, so a warp may start at its first column k0.
  const int k0 = (c / 32) * 32;
  for (int r = k0; r < B; ++r) {
    float acc = (r == c) ? 1.f : 0.f;
    for (int k = k0; k < r; ++k) acc -= Ls[r * B + k] * Xs[k * B + c];
    if (r >= c) Xs[r * B + c] = acc / Ls[r * B + r];
  }
  __syncthreads();

  float* Ob = out + (size_t)blk * B * B;
  for (int e = threadIdx.x; e < B * B; e += B) Ob[e] = Xs[e];
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (N/128, 128, 128): the inverse of each (128, 128) diagonal block of
// L (N, N), row-major.  N must be a multiple of 128 (the wrapper checks).
int tri_inv_panel_launch(const float* L, int N, float* out, void* stream) {
  const int smem = 2 * B * B * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tri_inv_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tri_inv_panel_kernel<<<N / B, B, smem, (cudaStream_t)stream>>>(L, N, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
