// Factor and invert one diagonal block of the blocked Cholesky, for Hopper
// (sm_90a).  Built into a shared library with a plain C interface and bound
// with ctypes (limbo_tpu_torch/ops/chol.py: _panel_factor_pallas).
//
// Replaces limbo_tpu/ops/chol.py: _panel_factor_pallas (_panel_kernel,
// _unrolled_pivot_chol, _unrolled_pivot_upper_inv).
//
// Input: the (B, B) top block D of the current panel, symmetric positive
// definite, row stride ldd.  Output, as the TPU kernel's: Lt = L11^T
// (upper, zero below the diagonal) and V = Lt^{-1} = L11^{-T} (upper), so
// the factorization's triangular solve for the rest of the panel is one GEMM.
//
// Bound on the H100: latency.  The bytes (the block in, two blocks out:
// 3 * B * B * 4 B = 196 KB at B = 128, ~59 ns at 3.35 TB/s) and the
// ~B^3/3 + B^3/3 flops (~1.4 MFLOP) are negligible.  What costs is the
// dependency chain: B pivot steps, each a square root, a row scale and a
// trailing update that the next pivot waits for, then the B-step
// substitution chain of the inverse.  The 132 calls of one factorization at
// N = 16896 run one after another between the factorization's GEMMs, so this
// kernel is the latency chain of the whole factorization.
//
// Design.  The TPU kernel held three (256, 256) f32 buffers, 768 KiB, above
// the 227 KB a Hopper block may use, and took w = 16 pivots per step to cut
// its sequential loop count.  Here B = 128 (ops/chol.py PANEL_BLOCK) and
// one block of 256 threads keeps two buffers resident: the working block S
// (64 KB) and the inverse (66 KB, its rows padded to B + 1).  The factor is
// right-looking and one pivot wide, working on the UPPER triangle (the
// block is symmetric), so the pivot row that every thread reads is
// contiguous: lanes read consecutive words, and the scalar of their row is
// a broadcast.  A negative pivot gives sqrt(<0) = NaN, which is NOT
// clamped: it spreads through the trailing update to every later pivot,
// exactly like the TPU kernel (chol.py:87-90), and reaches recompute's
// jitter-escalation retry.  The inverse X = L11^{-1} is forward
// substitution with thread c owning column c (as csrc/tri_inv.cu), stored
// transposed so that V = X^T leaves shared memory in coalesced rows.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;                 // ops/chol.py PANEL_BLOCK
constexpr int NT = 256;                // threads
constexpr int XLD = B + 1;             // padded row of the transposed inverse

__global__ void __launch_bounds__(NT)
panel_factor_kernel(const float* __restrict__ D, int ldd,
                    float* __restrict__ Lt, float* __restrict__ V) {
  extern __shared__ float smem[];
  float* S = smem;             // (B, B): upper triangle becomes Lt
  float* Xt = smem + B * B;    // (B, XLD): row c = column c of L11^{-1}
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  for (int e = t; e < B * B; e += NT) {
    const int r = e / B, c = e % B;
    S[e] = D[(size_t)r * ldd + c];
  }
  for (int e = t; e < B * XLD; e += NT) Xt[e] = 0.f;
  __syncthreads();

  // ---- factor: upper S <- L^T, one pivot at a time ----
  for (int k = 0; k < B; ++k) {
    // row k right of the pivot: L[j, k] = S[k, j] / sqrt(S[k, k])
    if (t > k && t < B) S[k * B + t] = S[k * B + t] / sqrtf(S[k * B + k]);
    __syncthreads();
    if (t == k) S[k * B + k] = sqrtf(S[k * B + k]);
    // trailing update of the upper triangle: S[i, j] -= L[i, k] L[j, k]
    for (int i = k + 1 + warp; i < B; i += NT / 32) {
      const float lik = S[k * B + i];
      for (int j = i + lane; j < B; j += 32) S[i * B + j] -= lik * S[k * B + j];
    }
    __syncthreads();
  }

  // ---- invert: X = L^{-1}, thread c owns column c; L[r, k] = S[k, r] ----
  if (t < B) {
    const int c = t;
    float* xc = Xt + c * XLD;
    const int k0 = (c / 32) * 32;   // X[k, c] = 0 for k < c
    for (int r = k0; r < B; ++r) {
      float acc = (r == c) ? 1.f : 0.f;
      for (int k = k0; k < r; ++k) acc -= S[k * B + r] * xc[k];
      if (r >= c) xc[r] = acc / S[r * B + r];
    }
  }
  __syncthreads();

  // Lt: the upper triangle of S; V = X^T: V[c, r] = X[r, c] = Xt[c, r]
  for (int e = t; e < B * B; e += NT) {
    const int r = e / B, c = e % B;
    Lt[e] = (c >= r) ? S[e] : 0.f;
    V[e] = Xt[r * XLD + c];
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lt, V (128, 128), row-major: L11^T and L11^{-T} of the SPD block D
// (128 x 128, row stride ldd >= 128).  The wrapper checks shapes.
int panel_factor_launch(const float* D, int ldd, float* Lt, float* V,
                        void* stream) {
  const int smem = (B * B + B * XLD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  panel_factor_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(D, ldd, Lt, V);
  return (int)cudaGetLastError();
}

}  // extern "C"
