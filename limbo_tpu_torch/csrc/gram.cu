// Fused covariance tiles for Hopper (sm_90a): the cross-covariance
// sf2 * rho(r^2) of two point sets, and the Cholesky-ready padded training
// covariance.  Built into a shared library with a plain C interface and
// bound with ctypes (limbo_tpu_torch/ops/gram_pallas.py).
//
// Replaces limbo_tpu/ops/gram_pallas.py: gram_pallas (_gram_kernel) and
// gram_train_pallas (_gram_train_kernel).
//
// Bound on the H100: the output write.  d is tiny (8 on the main path), so a
// tile costs 2*d flops per output against 4 bytes written: at (1024, 10240)
// the 42 MB write takes ~12.6 us at 3.35 TB/s while the f32 arithmetic
// takes a few us at 67 TFLOP/s.  The design therefore spends nothing on the
// tensor cores: each block stages a (64, DK) slice of both point sets in
// shared memory, every thread owns one output column and 16 rows of it, and
// a warp writes 32 consecutive floats of one row (128-byte coalesced
// stores).  The a.b dot runs in IEEE f32 on the CUDA cores, so the
// |a|^2 + |b|^2 - 2 a.b cancellation keeps full f32 precision, as the
// reference requires (limbo_tpu/utils/maths.py:29-34).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int THREADS = 256;  // TN columns x (THREADS / TN) row groups
constexpr int RG = THREADS / TN;
constexpr int RPT = TM / RG;  // rows per thread
constexpr int DK = 16;        // feature chunk staged in shared memory

enum Form { SE = 0, MATERN32 = 1, MATERN52 = 2 };

// Covariance from the squared distance r2 (limbo_tpu/ops/gram_pallas.py
// _radial): se takes length-scaled inputs; the Matern forms are isotropic
// with inv_l applied here and r2 floored at 1e-30 under the sqrt.
__device__ __forceinline__ float radial(int form, float r2, float inv_l) {
  if (form == SE) return expf(-0.5f * r2);
  float d = sqrtf(fmaxf(r2, 1e-30f));
  if (form == MATERN32) {
    float t = 1.7320508075688772f * inv_l * d;
    return (1.0f + t) * expf(-t);
  }
  float t = 2.23606797749979f * inv_l * d;
  float quad = (5.0f / 3.0f) * (inv_l * inv_l) * r2;
  return (1.0f + t + quad) * expf(-t);
}

// One (TM, TN) output tile.  TRAIN adds the training epilogue: entries with
// row, col < nvalid hold cov + diag_add * [row == col]; all others hold
// [row == col] (the masked-identity padding).
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS)
gram_tile_kernel(const float* __restrict__ X1, const float* __restrict__ X2,
                 int n, int m, int d, const float* __restrict__ sf2_p,
                 const float* __restrict__ inv_l_p,
                 const float* __restrict__ dadd_p, int nvalid, int form,
                 float* __restrict__ out) {
  __shared__ float as[DK][TM];
  __shared__ float bs[DK][TN];
  const int tx = threadIdx.x % TN;
  const int ty = threadIdx.x / TN;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int col = col0 + tx;

  float ab[RPT], a2[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) { ab[r] = 0.f; a2[r] = 0.f; }
  float b2 = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    // stage the (TM, DK) and (TN, DK) slices, transposed, zero-padded
    for (int e = threadIdx.x; e < TM * DK; e += THREADS) {
      int rr = e / DK, kk = e % DK;
      int gr = row0 + rr, gk = k0 + kk;
      as[kk][rr] = (gr < n && gk < d) ? X1[(size_t)gr * d + gk] : 0.f;
      int gc = col0 + rr;
      bs[kk][rr] = (gc < m && gk < d) ? X2[(size_t)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float b = bs[kk][tx];
      b2 += b * b;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float a = as[kk][ty + r * RG];
        ab[r] += a * b;
        a2[r] += a * a;
      }
    }
    __syncthreads();
  }

  if (col >= m) return;
  const float sf2 = *sf2_p;
  const float inv_l = *inv_l_p;
  const float dadd = TRAIN ? *dadd_p : 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    int row = row0 + ty + r * RG;
    if (row >= n) continue;
    float r2 = fmaxf(a2[r] + b2 - 2.0f * ab[r], 0.0f);
    float v = sf2 * radial(form, r2, inv_l);
    if (TRAIN) {
      float diag = (row == col) ? 1.0f : 0.0f;
      v = (row < nvalid && col < nvalid) ? v + dadd * diag : diag;
    }
    out[(size_t)row * m + col] = v;
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (n, m) = sf2 * rho(X1 (n, d), X2 (m, d)); sf2 and inv_l are device
// scalars so that the caller never waits on the card for them.
int gram_launch(const float* X1, const float* X2, int n, int m, int d,
                const float* sf2, const float* inv_l, int form, float* out,
                void* stream) {
  dim3 grid((m + TN - 1) / TN, (n + TM - 1) / TM);
  gram_tile_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      X1, X2, n, m, d, sf2, inv_l, nullptr, 0, form, out);
  return (int)cudaGetLastError();
}

// out (N, N): the padded training covariance of X (N, d) with nvalid valid
// rows (limbo_tpu/ops/gram_pallas.py _gram_train_kernel).
int gram_train_launch(const float* X, int N, int d, const float* sf2,
                      const float* inv_l, const float* diag_add, int nvalid,
                      int form, float* out, void* stream) {
  dim3 grid((N + TN - 1) / TN, (N + TM - 1) / TM);
  gram_tile_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      X, X, N, N, d, sf2, inv_l, diag_add, nvalid, form, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
