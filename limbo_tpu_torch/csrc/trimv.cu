// Triangle-only matvec for Hopper (sm_90a): y = L v or y = L^T v for a
// square lower-triangular f32 L, reading only the entries on and below the
// diagonal.  Built into a shared library with a plain C interface and bound
// with ctypes (limbo_tpu_torch/ops/trimv.py).
//
// Replaces limbo_tpu/ops/trimv.py: _trimv_pallas (_mv_kernel).
//
// Bound on the H100: the bytes of the triangle, N(N+1)/2 * 4 B (210 MB at
// N = 10240, ~63 us at 3.35 TB/s); two flops per 4-byte entry leave the
// arithmetic far below the card's rate.  The TPU kernel accumulated the
// output in a resident buffer across a sequential grid; Hopper blocks run
// in no order, so each output element is owned by exactly one thread group
// and summed in a fixed order: no float atomics, and a seeded run repeats
// bit for bit.
//   * L v   : one warp per row, lanes stride the row (coalesced 128-byte
//             reads), then a fixed-order warp shuffle reduction.
//   * L^T v : one block per 32-column strip; each of its 16 warps walks
//             every 16th row of the strip's sub-triangle with one column per
//             lane (coalesced row segments), then the 16 partial sums are
//             added in warp order through shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;     // rows per block in L v
constexpr int TWARPS = 16;   // row groups per column strip in L^T v

__global__ void __launch_bounds__(WARPS * 32)
lower_mv_kernel(const float* __restrict__ L, const float* __restrict__ v,
                int N, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* Lr = L + (size_t)row * N;
  float acc = 0.f;
  for (int c = lane; c <= row; c += 32) acc += Lr[c] * v[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

__global__ void __launch_bounds__(TWARPS * 32)
lower_tmv_kernel(const float* __restrict__ L, const float* __restrict__ v,
                 int N, float* __restrict__ y) {
  __shared__ float part[TWARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32;
  const int col = c0 + lane;
  float acc = 0.f;
  if (col < N) {
#pragma unroll 4
    for (int r = c0 + warp; r < N; r += TWARPS) {
      // entries above the diagonal (r < col) are not read
      if (r >= col) acc += L[(size_t)r * N + col] * v[r];
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < TWARPS; ++w) s += part[w][lane];
    y[col] = s;
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y (N,) = L v (transpose == 0) or L^T v (transpose != 0); L (N, N)
// row-major, only its lower triangle is read.
int trimv_launch(const float* L, const float* v, int N, int transpose,
                 float* y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (transpose) {
    lower_tmv_kernel<<<(N + 31) / 32, TWARPS * 32, 0, s>>>(L, v, N, y);
  } else {
    lower_mv_kernel<<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(L, v, N,
                                                                     y);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
