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
// ~2 B^3 / 3 flops (~1.4 MFLOP) are negligible.  What costs is the chain of
// dependent steps, each ended by a block barrier; the 132 calls of one
// factorization at N = 16896 run one after another between its GEMMs.
// A design that takes one pivot a step needs two barriers a pivot (256)
// and a 128-long substitution chain per thread for the inverse; this one
// cuts the chain into 32-wide sub-blocks, one warp's width.
//
// Design.  One block of 256 threads holds the working block S (lower
// triangle used) and the inverse X = L11^{-1} in shared memory, rows padded
// to B + 1 so that column reads fall on distinct banks.  For each of the 4
// diagonal sub-blocks (j0 = 0, 32, 64, 96):
//   1. warp 0 loads the 32 x 32 diagonal block into registers (lane j holds
//      column j), factors it right-looking with the pivot broadcast by
//      __shfl_sync and each pivot column through a 32-float shared buffer
//      (warp syncs only, no block barrier), then inverts the factor by
//      column-oriented substitution (lane c owns column c of the inverse);
//   2. all 8 warps form the sub-panel below it, L21 = S21 X11^T (<= 96 x 32);
//   3. all 8 warps subtract L21 L21^T from the lower triangle of the
//      trailing block (<= 96 x 96).
// Steps 2 and 3, and the assembly of the off-diagonal blocks of X by block
// substitution (row block a: T = L[a, :a] X[:a, :a], then X[a, :a] =
// -X[a, a] T), are shared-memory GEMMs on the CUDA cores, each thread a
// 4 x 4 tile of outputs.  20 block barriers in all.  Everything is f32
// on CUDA cores in IEEE arithmetic (no TF32): the column scale and the
// inverse's diagonal multiply by the pivot's reciprocal square root,
// correctly rounded (__frsqrt_rn), where a division would sit on the chain,
// and L's diagonal is sqrtf's.  A negative pivot gives rsqrt(<0) = NaN,
// NOT clamped: it spreads through its sub-block's factor (selects, not
// branches, keep it out of the columns finished before it), the sub-panel
// product and the trailing update to every later pivot, while the entries
// before it stay finite, like the TPU kernel (chol.py:87-90); it reaches
// recompute's jitter-escalation retry.
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_panel_split.py,
// clock64() stamps in a patched copy): 115,957 cycles a call, against
// 611,390 for one pivot a step; the factor chain (diagonal factors 49,521
// and panel GEMMs 24,544) is 0.64 of it and the inverse chain (diagonal
// inverses 10,584 and the assembly of X 18,831) 0.25.  The warp-serial
// diagonal factors are the largest part: 32 pivot steps of ~390 cycles
// each a sub-block.  The correctly rounded reciprocal square root costs
// ~7,600 cycles (7%) over the approximate rsqrtf.  Running the next
// diagonal block on warp 0 while warps 1-7 ran the trailing product and
// the assembly of X (a look-ahead) gained 4% and was not kept.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;                 // ops/chol.py PANEL_BLOCK
constexpr int W = 32;                  // sub-block: one warp's width
constexpr int NT = 256;                // threads
constexpr int LD = B + 1;              // padded rows of S and X
constexpr int TLD = B - W + 1;         // padded rows of T (32 x 96)
constexpr int SMEM = (2 * B * LD + W * TLD) * (int)sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

// C = alpha A B (+ C if add), called by every thread of the block.
// A(i, k) = A[i lda + k], B(k, n) = B[k bk + n bn]; M and N multiples of 4.
// Each thread takes a 4 x 4 tile of outputs at rows ti + s M/4 and columns
// tj + u N/4, so a warp's loads are broadcasts or fall on distinct banks.
// With `inplace` (C overlaps A or B) every product is taken before any is
// stored, which needs one round (M N <= 16 NT).  With `lower` only i >= j
// is stored.
__device__ void block_gemm(int M, int N, int K, const float* A, int lda,
                           const float* Bm, int bk, int bn, float* C, int ldc,
                           float alpha, bool add, bool lower, bool inplace) {
  const int t = threadIdx.x;
  const int mt = M / 4, nt = N / 4, tiles = mt * nt;
  for (int base = 0; base < tiles; base += NT) {
    const int tile = base + t;
    const bool on = tile < tiles;
    const int ti = on ? tile / nt : 0, tj = on ? tile % nt : 0;
    float c[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int u = 0; u < 4; ++u) c[s][u] = 0.f;
    if (on) {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[s] = A[(ti + s * mt) * lda + k];
          b[s] = Bm[k * bk + (tj + s * nt) * bn];
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int u = 0; u < 4; ++u) c[s][u] = fmaf(a[s], b[u], c[s][u]);
      }
    }
    if (inplace) __syncthreads();
    if (on) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = ti + s * mt, j = tj + u * nt;
          if (lower && i < j) continue;
          const float v = alpha * c[s][u];
          C[i * ldc + j] = add ? C[i * ldc + j] + v : v;
        }
    }
  }
}

// Warp 0: factor the 32 x 32 diagonal block at (j0, j0) of S in registers
// and write its factor to S (lower, zero above) and the reciprocals of its
// diagonal to dinv.  Lanes are selected with selects, not branches, so a
// NaN pivot does not reach the columns finished before it.
__device__ void factor_diag(float* S, float* pivcol, float* dinv, int j0,
                            int lane) {
  float col[W];   // lane j: column j of the symmetric block (its lower half)
#pragma unroll
  for (int i = 0; i < W; ++i)
    col[i] = S[(j0 + max(i, lane)) * LD + j0 + min(i, lane)];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float d = __shfl_sync(FULL, col[k], k);
    const float inv = __frsqrt_rn(d);     // NaN for d < 0: not clamped
    const float l = col[k] * inv;         // L[lane, k] for lane > k
    pivcol[lane] = l;
    __syncwarp();
    float p[W];
#pragma unroll
    for (int g = (k + 1) / 4; g < W / 4; ++g) {   // broadcast reads
      const float4 v = reinterpret_cast<const float4*>(pivcol)[g];
      p[4 * g] = v.x;
      p[4 * g + 1] = v.y;
      p[4 * g + 2] = v.z;
      p[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = k + 1; i < W; ++i) {
      const float v = fmaf(-p[i], l, col[i]);
      col[i] = lane > k ? v : (lane == k ? p[i] : col[i]);
    }
    if (lane == k) {
      col[k] = sqrtf(d);
      dinv[k] = inv;
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < W; ++i)   // lane j now holds L[i, j] for i >= j
    S[(j0 + i) * LD + j0 + lane] = i >= lane ? col[i] : 0.f;
  __syncwarp();
}

// Warp 0: X11 = L11^{-1} of the factored diagonal block, lane c computing
// column c by column-oriented substitution (L from S, broadcast reads); the
// entries above the diagonal are stored as zeros.
__device__ void invert_diag(const float* S, const float* dinv, float* X,
                            int j0, int lane) {
  float x[W];
#pragma unroll
  for (int r = 0; r < W; ++r) x[r] = r == lane ? 1.f : 0.f;
#pragma unroll
  for (int m = 0; m < W; ++m) {
    x[m] *= dinv[m];
#pragma unroll
    for (int r = m + 1; r < W; ++r)
      x[r] = fmaf(-S[(j0 + r) * LD + j0 + m], x[m], x[r]);
  }
#pragma unroll
  for (int r = 0; r < W; ++r)
    X[(j0 + r) * LD + j0 + lane] = r >= lane ? x[r] : 0.f;
}

__global__ void __launch_bounds__(NT, 1)
panel_factor_kernel(const float* __restrict__ D, int ldd,
                    float* __restrict__ Lt, float* __restrict__ V) {
  extern __shared__ float smem[];
  __shared__ __align__(16) float pivcol[W];
  __shared__ float dinv[W];
  float* S = smem;              // (B, LD): lower triangle becomes L11
  float* X = S + B * LD;        // (B, LD): L11^{-1}, lower
  float* T = X + B * LD;        // (W, TLD): one block row's partial product
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  for (int e = t; e < B * B; e += NT) {
    const int r = e / B, c = e % B;
    S[r * LD + c] = D[(size_t)r * ldd + c];
    X[r * LD + c] = 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < B; j0 += W) {
    if (warp == 0) {
      factor_diag(S, pivcol, dinv, j0, lane);
      invert_diag(S, dinv, X, j0, lane);
    }
    __syncthreads();
    const int R = B - j0 - W;   // rows below the diagonal block
    if (R > 0) {
      float* S21 = S + (j0 + W) * LD + j0;
      // L21 = S21 X11^T, in place
      block_gemm(R, W, W, S21, LD, X + j0 * LD + j0, 1, LD, S21, LD, 1.f,
                 false, false, true);
      __syncthreads();
      // S22 -= L21 L21^T, lower triangle
      block_gemm(R, R, W, S21, LD, S21, 1, LD, S21 + W, LD, -1.f, true,
                 true, false);
      __syncthreads();
    }
  }

  // off-diagonal blocks of X, block row by block row
  for (int a = W; a < B; a += W) {
    // T = L[a-rows, :a] X[:a, :a]
    block_gemm(W, a, a, S + a * LD, LD, X, LD, 1, T, TLD, 1.f, false, false,
               false);
    __syncthreads();
    // X[a-rows, :a] = -X[a, a] T
    block_gemm(W, a, W, X + a * LD + a, LD, T, TLD, 1, X + a * LD, LD, -1.f,
               false, false, false);
    __syncthreads();
  }

  // Lt = L11^T: Lt[r, c] = S[c, r] for c >= r; V = X^T: V[r, c] = X[c, r]
  for (int e = t; e < B * B; e += NT) {
    const int r = e / B, c = e % B;
    Lt[e] = c >= r ? S[c * LD + r] : 0.f;
    V[e] = X[c * LD + r];
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lt, V (128, 128), row-major: L11^T and L11^{-T} of the SPD block D
// (128 x 128, row stride ldd >= 128).  The wrapper checks shapes.  The
// shared-memory opt-in is asked for once a process.
int panel_factor_launch(const float* D, int ldd, float* Lt, float* V,
                        void* stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (set != cudaSuccess) return (int)set;
  panel_factor_kernel<<<1, NT, SMEM, (cudaStream_t)stream>>>(D, ldd, Lt, V);
  return (int)cudaGetLastError();
}

}  // extern "C"
