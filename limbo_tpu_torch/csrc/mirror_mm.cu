// The bf16 mirror product of the cached query, for Hopper (sm_90a):
// C = bf16(A) @ Bm with f32 sums rounded to nearest.  Built into a shared
// library with a plain C interface and bound with ctypes
// (limbo_tpu_torch/ops/mirror.py).
//
// This is a kernel of the port, not the port of a TPU kernel: the
// reference's product is an XLA dot with bf16 operands and
// preferred_element_type=f32 (limbo_tpu/models/gp.py:496-497, 534-535).
// Its contract is the exact products of the bf16 operands summed in f32.
// The card's mixed-dtype tensor-core GEMM truncates as it accumulates, a
// bias toward zero that grows with the depth; this kernel sums on the CUDA
// cores with IEEE round-to-nearest FMAs instead.  A bf16 x bf16 product has
// at most 16 significant bits, so each FMA's product is exact and only the
// sums round.
//
// Bound on the H100, for the function: the larger of the bytes (K N bf16
// read once, 571 MB at N = 16896: ~0.17 ms) and 2 q K N operations at the
// dense bf16 tensor-core rate (989 TFLOP/s), since f32 sums of the exact
// products can also come from tensor-core partial sums promoted to f32
// registers: ~0.17 ms (bytes) at q = 64, ~0.59 ms (operations) at the
// q = 1024 sweep.  This design's own ceiling is those operations at the
// f32 rate of the CUDA cores (67 TFLOP/s): ~0.55 ms and ~8.7 ms.
//
// Design: a SIMT GEMM.  A block of 256 threads owns a 64 x 128 tile of C;
// each thread owns 4 x 8 outputs (4 rows, and two runs of 4 columns 64
// apart), read from shared memory as float4s.  The depth is walked in
// slices of 32.  Each slice arrives through a 3-stage ring of raw tiles
// filled by cp.async (A as f32, Bm as bf16, 16 bytes a copy), so two
// slices are in flight while one is multiplied; the block then widens the
// slice into f32 compute tiles (A rounded to bf16 on the way), and every
// thread runs its FMAs from those.  Shapes whose rows are not 16-byte
// multiples (K % 4 or N % 8 not 0) fill the ring with plain loads instead.
// Every output is summed in one fixed order: inside a slice a running FMA
// chain, and the 32-term slice sums added in slice order to the
// accumulator, which keeps the rounding of one long sum near sqrt(K / 32)
// slice additions instead of K.  At the query's q = 64 a grid of 64 x 128
// tiles holds fewer blocks than two per SM, so the depth is split into
// `splits` chunks, each block writing its chunk's partial sums to a
// workspace, and a second kernel adds the chunks in chunk order.  No
// atomics: a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int NT = 256;             // 16 x 16 threads, 4 x 8 outputs each
constexpr int APAD = BM + 4;        // keeps float4 rows aligned
constexpr int STAGES = 3;
constexpr int RING_A = BM * BK;     // f32 per stage
constexpr int RING_B = BK * BN;     // bf16 per stage
constexpr int SMEM = STAGES * (RING_A * 4 + RING_B * 2) + BK * APAD * 4 +
                     BK * BN * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
mirror_mm_kernel(const float* __restrict__ A,
                 const __nv_bfloat16* __restrict__ Bm, int q, int K, int N,
                 int kchunk, float* __restrict__ C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ringA = reinterpret_cast<float*>(smem);                // [S][BM][BK]
  __nv_bfloat16* ringB =
      reinterpret_cast<__nv_bfloat16*>(ringA + STAGES * RING_A);  // [S][BK][BN]
  float* As = reinterpret_cast<float*>(ringB + STAGES * RING_B);  // [BK][APAD]
  float* Bs = As + BK * APAD;                                   // [BK][BN]
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nslices = (kend - kbeg + BK - 1) / BK;
  float* Cz = C + (size_t)blockIdx.z * q * N;   // this chunk's partial sums

  // raw slice `sl` of the chunk into ring stage `st` (zeros off the edges)
  auto fetch = [&](int sl, int st) {
    const int k0 = kbeg + sl * BK;
    float* ra = ringA + st * RING_A;
    __nv_bfloat16* rb = ringB + st * RING_B;
    if (VEC) {
      for (int c = t; c < RING_A / 4; c += NT) {   // 4 floats of one row
        const int r = c / (BK / 4), kk = (c % (BK / 4)) * 4;
        const int gr = row0 + r, gk = k0 + kk;
        const bool in = gr < q && gk < kend;
        cp_async16(ra + r * BK + kk, in ? A + (size_t)gr * K + gk : A,
                   in ? 16 : 0);
      }
      for (int c = t; c < RING_B / 8; c += NT) {   // 8 bf16 of one row
        const int kk = c / (BN / 8), cc = (c % (BN / 8)) * 8;
        const int gk = k0 + kk, gc = col0 + cc;
        const bool in = gk < kend && gc < N;
        cp_async16(rb + kk * BN + cc, in ? Bm + (size_t)gk * N + gc : Bm,
                   in ? 16 : 0);
      }
    } else {
      for (int e = t; e < RING_A; e += NT) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        ra[e] = (gr < q && gk < kend) ? A[(size_t)gr * K + gk] : 0.f;
      }
      for (int e = t; e < RING_B; e += NT) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = col0 + c;
        rb[e] = (gk < kend && gc < N) ? Bm[(size_t)gk * N + gc]
                                      : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int sl = 0; sl < STAGES - 1; ++sl) {
    if (sl < nslices) fetch(sl, sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < nslices; ++sl) {
    cp_async_wait_ring();          // this thread's copies of slice sl landed
    __syncthreads();               // everyone's, and the last FMAs are done
    const int st = sl % STAGES;
    const float* ra = ringA + st * RING_A;
    const __nv_bfloat16* rb = ringB + st * RING_B;
    for (int e = t; e < RING_A; e += NT)
      As[(e % BK) * APAD + e / BK] =
          __bfloat162float(__float2bfloat16_rn(ra[e]));
    for (int e = t; e < RING_B; e += NT) Bs[e] = __bfloat162float(rb[e]);
    __syncthreads();
    if (sl + STAGES - 1 < nslices) fetch(sl + STAGES - 1, (sl + STAGES - 1) % STAGES);
    cp_async_commit();
    float part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * APAD + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * BN + BN / 2 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
  }
  asm volatile("cp.async.wait_all;\n" ::);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
      if (c < N) Cz[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// C[e] = sum over chunks z = 0, 1, ... of W[z][e], in that order
__global__ void chunk_sum_kernel(const float* __restrict__ W, int splits,
                                 size_t count, float* __restrict__ C) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = W[e];
    for (int z = 1; z < splits; ++z) s += W[(size_t)z * count + e];
    C[e] = s;
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C (q, N) f32 = bf16(A) (q, K) @ Bm (K, N) bf16, all row-major and
// contiguous (the wrapper checks).  With splits > 1 the depth is cut into
// chunks of kchunk (a multiple of 32) whose partial sums go to the
// workspace W (splits, q, N) before they are added in order into C.
int mirror_mm_launch(const float* A, const void* Bm, int q, int K, int N,
                     int splits, int kchunk, float* W, float* C,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N + BN - 1) / BN, (q + BM - 1) / BM, splits);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(Bm);
  float* out = splits > 1 ? W : C;
  // 16-byte copies need 16-byte rows and bases (kchunk is a multiple of 32)
  const bool vec = K % 4 == 0 && N % 8 == 0 &&
                   reinterpret_cast<size_t>(A) % 16 == 0 &&
                   reinterpret_cast<size_t>(Bm) % 16 == 0;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(mirror_mm_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    mirror_mm_kernel<true><<<grid, NT, SMEM, st>>>(A, B, q, K, N, kchunk,
                                                   out);
  } else {
    err = cudaFuncSetAttribute(mirror_mm_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    mirror_mm_kernel<false><<<grid, NT, SMEM, st>>>(A, B, q, K, N, kchunk,
                                                    out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)q * N;
  chunk_sum_kernel<<<264, 256, 0, st>>>(W, splits, count, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
