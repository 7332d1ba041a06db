// The bf16 mirror product of the cached query, for Hopper (sm_90a):
// C = bf16(A) @ Bm with f32 sums.  Built into a shared library with a plain
// C interface and bound with ctypes (limbo_tpu_torch/ops/mirror.py).
//
// This is a kernel of the port, not the port of a TPU kernel: the
// reference's product is an XLA dot with bf16 operands and
// preferred_element_type=f32 (limbo_tpu/models/gp.py:496-497, 534-535).
// Its contract is the exact products of the bf16 operands summed in f32.
//
// Bound on the H100, for the function: the larger of the bytes (K N bf16
// read once, 571 MB at N = 16896: ~0.17 ms) and 2 q K N operations at the
// dense bf16 tensor-core rate (989 TFLOP/s): ~0.17 ms (bytes) at the
// query's q = 64, ~0.59 ms (operations) at the q = 1024 sweep.
//
// Design: tensor-core products with f32 promotion.  The card's bf16 MMA
// takes the products exactly but truncates as it adds them into its f32
// accumulator; a GEMM that carries one accumulator through the whole depth
// (the library's) piles that truncation up into a bias toward zero that
// grows with the depth (-4.5e-5 relative at K = 10240).  Here each
// promotion interval of PK along the depth is summed by mma.sync.m16n8k16
// into a fragment that starts at zero, and the fragment is then added with
// an IEEE round-to-nearest f32 add to a register accumulator, interval by
// interval in depth order.  A truncating run is then at most PK deep, so
// its bias scales with PK and not with K.
//
// The promotion interval PK is the design's one constant, 64: one interval
// a depth slice.  Measured on an H100 80GB HBM3 at 700 W by
// scripts/torch_mirror_tune.py, which builds this source with
// -DMIRROR_PROMOTION=16, 32 or 64: the mean signed relative error on
// |ks| @ |Kq| at K = 16896 (the hp path's covariance), the largest
// per-entry error over its limit sqrt(K) 2^-24 sum|terms| at the card
// tests' shapes, and the kernel's ms at q = 1024 and q = 64, N = 16896:
//   PK = 16: -6.86e-8, 0.314, 2.311 ms, 0.2425 ms
//   PK = 32: -1.16e-7, 0.341, 1.850 ms, 0.2434 ms
//   PK = 64: -2.21e-7, 0.373, 1.750 ms, 0.2436 ms
// Every interval passes (bias limit 1e-6, per-entry share 1), and 64 is
// the fastest.  An interval of 128 spans two slices; a build that took it
// also passed but was 13% slower at q = 1024 with twice the bias
// (-4.54e-7), so that path is gone.
//
// * A is rounded to bf16 (round to nearest) once, by a small pre-pass into
//   a zero-padded bf16 buffer laid out as the kernel's shared tiles (one
//   BM x 64 slice contiguous, its 16-byte chunks XOR-swizzled by row), so
//   one bulk copy brings a slice and ldmatrix reads it without bank
//   conflicts.  Every column tile re-reads all of A from L2, so the
//   pre-pass also halves that traffic against rounding f32 on the way in.
// * Bm streams through a 4-stage ring of 64-deep slices, each slice two
//   64 x 64 boxes fetched by the tensor-memory accelerator (one thread
//   issues them, an mbarrier a stage counts their bytes; zeros past K and
//   N; 128-byte swizzle, so ldmatrix.trans reads conflict-free).  A ring
//   fed by per-thread 16-byte cp.async copies reached ~3 TB/s from L2
//   whatever the tile, and one bulk copy per row of Bm was slower still;
//   the tensor boxes are what took q = 64 from 0.267 to 0.241 ms (PERF.md).
//   Bm is read as stored, (K, N) row-major; the mirror K^-1 is symmetric,
//   so this is also its N-major read, but the kernel takes any Bm (the
//   tests' are not).  Rows of Bm that are not 16-byte multiples (N % 8 != 0,
//   or a misaligned base) fill the ring with plain loads instead.
// * A block of 256 threads (8 warps, 2 x 4) owns a BM x 128 tile of C, BM
//   = 64 for q <= 64 (two blocks an SM) and 128 above (one).
// * At q = 64 the column tiles alone hold fewer blocks than two an SM, so
//   the depth is cut into `splits` chunks (multiples of BK) whose partial
//   sums go to a workspace; a second kernel adds the chunks in chunk
//   order.  No atomics: a run repeats bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128, BK = 64, STAGES = 4, NT = 256;
constexpr int BOX = 64;  // Bm's copy box: 64 columns (128 bytes) x BK rows
constexpr int KSTEPS = BK / 16;  // k16 MMAs a slice
#ifndef MIRROR_PROMOTION
#define MIRROR_PROMOTION 64
#endif
constexpr int PK = MIRROR_PROMOTION;  // the promotion interval
static_assert(PK % 16 == 0 && BK % PK == 0, "PK: 16, 32 or 64");
constexpr int PSTEPS = PK / 16;       // k16 MMAs an interval

template <int BM>
constexpr int smem_bytes() {   // + 1 KB to align the ring to 1024 bytes
  return STAGES * (BM + BN) * BK * 2 + 1024;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier of one ring stage: one arrival (the issuing thread, with the
// stage's byte count) and the copies' completed bytes end its phase
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the copy engine, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one BOX x BK box of Bm at (column x, row y) by the tensor-memory
// accelerator, 128-byte swizzled, zeros past the tensor's edges
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d = a b + c on the tensor cores (16 x 8 x 16, bf16 in, f32 out)
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// A16 = bf16_rn(A (q, K)), zero outside A, laid out as the kernel's shared
// tiles: tile (row tile rt of bm rows, slice ks of BK) is bm x BK
// contiguous at (rt Kp / BK + ks) bm BK, its 16-byte chunk c of row r
// stored at chunk c ^ (r % 8), so one bulk copy brings a whole A slice and
// ldmatrix reads it without bank conflicts.
__global__ void round_a_kernel(const float* __restrict__ A, int q, int K,
                               int qp, int Kp, int bm,
                               __nv_bfloat16* __restrict__ A16) {
  for (int r = blockIdx.x; r < qp; r += gridDim.x) {
    const int rt = r / bm, rr = r % bm;
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
      const int ks = k / BK, c = (k % BK) / 8, e = k % 8;
      const size_t at = ((size_t)rt * (Kp / BK) + ks) * bm * BK +
                        rr * BK + ((c ^ (rr & 7)) * 8 + e);
      A16[at] =
          __float2bfloat16_rn(r < q && k < K ? A[(size_t)r * K + k] : 0.f);
    }
  }
}

// element (row k, column n) of a stage of Bm: BN / BOX boxes of BK rows of
// 128 bytes, 16-byte chunk c of row k at chunk c ^ (k % 8) (the TMA's
// 128-byte swizzle)
__device__ __forceinline__ int b_at(int k, int n) {
  return (n / BOX) * BK * BOX + k * BOX + ((((n % BOX) / 8) ^ (k & 7)) * 8) +
         n % 8;
}

// BM x BN tile of C (or of chunk z's partial sums), promotion every PK
template <int BM, bool VEC>
__global__ void __launch_bounds__(NT, BM == 64 ? 2 : 1)
mirror_mm_kernel(const __grid_constant__ CUtensorMap mapB,
                 const __nv_bfloat16* __restrict__ A16, int Kp,
                 const __nv_bfloat16* __restrict__ Bm, int q, int K, int N,
                 int kchunk, float* __restrict__ C) {
  constexpr int WM = BM / 2, MI = WM / 16;   // warp tile WM x WN
  constexpr int WN = BN / 4, NI = WN / 8;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  // the swizzle is a function of the address: align the ring to 1024 bytes
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sA = sB + STAGES * BK * BN;      // [S][BM][BK], swizzled
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nk = (kend - kbeg + BK - 1) / BK;
  float* Cz = C + (size_t)blockIdx.z * q * N;   // this chunk's sums
  const CUtensorMap* mb = &mapB;

  // slice `sl` of the chunk into ring stage `st`.  Thread 0 asks for A's
  // slice (one bulk copy) and Bm's boxes (one tensor copy each; zeros past
  // K and N).  Shapes a tensor map cannot take (rows of Bm that are not
  // 16-byte multiples) fill Bm's part with plain loads by every thread.
  auto fetch = [&](int sl, int st) {
    const int k0 = kbeg + sl * BK;
    __nv_bfloat16* a = sA + st * BM * BK;
    __nv_bfloat16* b = sB + st * BK * BN;
    if (t == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(&full[st], (BM + (VEC ? BN : 0)) * BK * 2);
      bulk_copy(a, A16 + ((size_t)blockIdx.x * (Kp / BK) + k0 / BK) * BM * BK,
                BM * BK * 2, &full[st]);
      if (VEC)
#pragma unroll
        for (int x = 0; x < BN / BOX; ++x)
          tma_box(b + x * BK * BOX, mb, col0 + x * BOX, k0, &full[st]);
    }
    if (!VEC) {
      const int rows = min(BK, kend - k0);
      for (int e = t; e < BK * BN; e += NT) {
        const int kk = e / BN, cc = e % BN;
        b[b_at(kk, cc)] = (kk < rows && col0 + cc < N)
                              ? Bm[(size_t)(k0 + kk) * N + col0 + cc]
                              : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = part[i][j][r] = 0.f;

  if (t < STAGES) mbar_init(&full[t]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  for (int sl = 0; sl < STAGES - 1 && sl < nk; ++sl) fetch(sl, sl);
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);   // slice kt landed
    __syncthreads();   // and everyone is done with slice kt - 1
    if (kt + STAGES - 1 < nk)
      fetch(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    const __nv_bfloat16* a = sA + (kt % STAGES) * BM * BK;
    const __nv_bfloat16* b = sB + (kt % STAGES) * BK * BN;
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      unsigned af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm * WM + i * 16 + (lane & 15);
        const int c = j * 2 + (lane >> 4);          // 16-byte chunk of row r
        ldsm_x4(af[i], a + r * BK + ((c ^ (r & 7)) * 8));
      }
#pragma unroll
      for (int p = 0; p < NI / 2; ++p) {
        unsigned r[4];
        ldsm_x4_t(r, b + b_at(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              wn * WN + p * 16 + (lane >> 4) * 8));
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
      // the interval starts (zero fragment) and ends (promote) here
      const bool first = j % PSTEPS == 0, last = j % PSTEPS == PSTEPS - 1;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          float c[4], d[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) c[r] = first ? 0.f : part[i][n][r];
          mma16816(d, af[i], bf[n][0], bf[n][1], c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (last) acc[i][n][r] += d[r];
            else part[i][n][r] = d[r];
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * WM + i * 16 + (lane >> 2) + h * 8;
      if (r >= q) continue;
#pragma unroll
      for (int n = 0; n < NI; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + wn * WN + n * 8 + (lane & 3) * 2 + e;
          if (c < N) Cz[(size_t)r * N + c] = acc[i][n][h * 2 + e];
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

// the shared-memory opt-in of one instantiation, asked for once a process
template <int BM, bool VEC>
cudaError_t configured() {
  static const cudaError_t err = cudaFuncSetAttribute(
      mirror_mm_kernel<BM, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM>());
  return err;
}

struct Args {
  CUtensorMap mapB;
  const __nv_bfloat16* A16;
  int Kp;
  const __nv_bfloat16* B;
  int q, K, N, kchunk;
  float* out;
};

template <int BM>
cudaError_t run(bool vec, dim3 grid, cudaStream_t st, const Args& a) {
  cudaError_t err = vec ? configured<BM, true>() : configured<BM, false>();
  if (err != cudaSuccess) return err;
  if (vec)
    mirror_mm_kernel<BM, true><<<grid, NT, smem_bytes<BM>(), st>>>(
        a.mapB, a.A16, a.Kp, a.B, a.q, a.K, a.N, a.kchunk, a.out);
  else
    mirror_mm_kernel<BM, false><<<grid, NT, smem_bytes<BM>(), st>>>(
        a.mapB, a.A16, a.Kp, a.B, a.q, a.K, a.N, a.kchunk, a.out);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once a process
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Bm (K, N) bf16 as BOX x BK boxes, 128-byte swizzled, zeros outside
bool encode_b(CUtensorMap* map, const void* Bm, int K, int N) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {BOX, BK}, one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(Bm),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C (q, N) f32 = bf16(A) (q, K) @ Bm (K, N) bf16, all row-major and
// contiguous (the wrapper checks).  bm (64 or 128) is the row tile, which
// the wrapper picks from q and sizes the workspaces with.  A16 is a bf16
// workspace of roundup(q, bm) x roundup(K, 64) elements.  With splits > 1
// the depth is cut into chunks of kchunk (a multiple of 64) whose partial
// sums go to the workspace W (splits, q, N) before they are added in order
// into C.  The shared-memory opt-in and cuTensorMapEncodeTiled
// are looked up once a process; their errors come back from here.
int mirror_mm_launch(const float* A, const void* Bm, int q, int K, int N,
                     int bm, int splits, int kchunk,
                     void* A16, float* W, float* C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((bm != 64 && bm != 128) || kchunk % BK != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int qp = (q + bm - 1) / bm * bm, Kp = (K + BK - 1) / BK * BK;
  __nv_bfloat16* a16 = static_cast<__nv_bfloat16*>(A16);
  if ((size_t)qp * Kp) {
    round_a_kernel<<<264, 256, 0, st>>>(A, q, K, qp, Kp, bm, a16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(qp / bm, (N + BN - 1) / BN, splits);
  Args args{{}, a16, Kp, static_cast<const __nv_bfloat16*>(Bm), q, K, N,
            kchunk, splits > 1 ? W : C};
  // a tensor map of Bm needs 16-byte rows and base
  bool vec = N % 8 == 0 && reinterpret_cast<size_t>(Bm) % 16 == 0 && K > 0;
  if (vec && !encode_b(&args.mapB, Bm, K, N)) return (int)cudaErrorUnknown;
  cudaError_t err =
      bm == 64 ? run<64>(vec, grid, st, args) : run<128>(vec, grid, st, args);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)q * N;
  chunk_sum_kernel<<<264, 256, 0, st>>>(W, splits, count, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
