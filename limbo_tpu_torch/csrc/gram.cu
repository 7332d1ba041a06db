// Fused covariance tiles for Hopper (sm_90a): the cross-covariance
// sf2 * rho(r^2) of two point sets, and the Cholesky-ready padded training
// covariance.  Built into a shared library with a plain C interface and
// bound with ctypes (limbo_tpu_torch/ops/gram_pallas.py).
//
// Replaces limbo_tpu/ops/gram_pallas.py: gram_pallas (_gram_kernel) and
// gram_train_pallas (_gram_train_kernel).
//
// Bound on the H100: the output write.  d is tiny (8 on both paths), so a
// tile costs ~2 d flops and one exp per output against 4 bytes written: the
// (N, N) training covariance at N = 16896 is a 1.14 GB write (0.34 ms at
// 3.35 TB/s).  The design spends nothing on the tensor cores and keeps the
// instruction stream short enough to hide under the stores:
//
// * Block tile TM x 128 (TM = 128, or 32 where 128-row tiles would leave the
//   card under two blocks an SM: the q = 64 rows of the acquisition ascent).
//   Each thread owns a 4 x 4 register micro-tile a step: four columns for
//   the whole tile and four rows at each of TM / 32 steps.  The features
//   are staged feature-major in shared memory, so a thread reads four rows
//   (or four columns) of one feature as one 16-byte load: 16 FMAs for two
//   loads, and its columns stay in registers across the steps.
// * Features in chunks of 8 (d = 8 on both paths, one chunk); a larger d
//   restages chunk by chunk, zero-padded, in the same kernel.
// * |a|^2 and |b|^2 from the staged features, in registers: a thread's
//   four columns once, its four rows at each step, with the same FMAs in
//   the same order for rows and columns, so the training covariance of X
//   with itself is exactly symmetric (a.b too runs the same FMAs in the
//   same order both ways).  The prologue issues every global load before
//   it writes any: one trip to memory.
// * 16-byte stores: a warp is 4 row blocks x 8 column blocks, so one store
//   instruction writes four 128-byte row segments.  A row stride that is
//   not a multiple of 4 floats takes a scalar path in the same kernel.
// * The training covariance computes only the tiles with I >= J and writes
//   each off-diagonal tile twice, as it is and transposed (a thread's 4 x 4
//   micro-tile is its own transpose's: four 16-byte stores down a column
//   block).  Tiles wholly in the padding write the identity (zeros off the
//   diagonal) with no arithmetic.  Its stores are streaming (st.global.cs):
//   the matrix far exceeds the 50 MB L2.  The cross-covariance keeps plain
//   stores: the bf16 mirror's pre-pass reads it straight after.
//
// The a.b dot runs in IEEE f32 FMAs on the CUDA cores (no TF32), so the
// |a|^2 + |b|^2 - 2 a.b cancellation keeps full f32 precision, as the
// reference requires (limbo_tpu/utils/maths.py:29-34).  The exp is the
// accurate expf: the approximate __expf measured at most 5% faster on an
// H100 (scripts/torch_gram_split.py times it as a variant).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 8 warps: 2 (row blocks) x 4 (column blocks)
constexpr int TN = 128;       // output columns per block tile
constexpr int DK = 8;         // feature chunk staged in shared memory
constexpr int PAD = 4;        // floats of padding per staged feature row
constexpr int MIN_BLOCKS = 2; // blocks an SM the registers must allow

enum Form { SE = 0, MATERN32 = 1, MATERN52 = 2 };

// Covariance from the squared distance r2 (limbo_tpu/ops/gram_pallas.py
// _radial): se takes length-scaled inputs; the Matern forms are isotropic
// with inv_l applied here and r2 floored at 1e-30 under the sqrt.
template <int FORM>
__device__ __forceinline__ float radial(float r2, float inv_l) {
  if (FORM == SE) return expf(-0.5f * r2);
  float d = sqrtf(fmaxf(r2, 1e-30f));
  if (FORM == MATERN32) {
    float t = 1.7320508075688772f * inv_l * d;
    return (1.0f + t) * expf(-t);
  }
  float t = 2.23606797749979f * inv_l * d;
  float quad = (5.0f / 3.0f) * (inv_l * inv_l) * r2;
  return (1.0f + t + quad) * expf(-t);
}

// Features [k0, k0 + DK) of `ROWS` rows from row r0 of X (nrows, d), zero
// past the ends: this thread's share, read into registers (consecutive
// threads read consecutive floats of X), then written feature-major into
// S[DK][ROWS + PAD], where the padding spreads the writes over all 32 banks.
// A tile's loads all issue before any is written, so the staging costs one
// trip to memory.
template <int ROWS>
struct Slice {
  static_assert(ROWS * DK % THREADS == 0, "whole staging rounds");
  static constexpr int PER = ROWS * DK / THREADS;
  float v[PER];

  __device__ __forceinline__ void load(const float* __restrict__ X, int r0,
                                       int nrows, int d, int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int e = threadIdx.x + i * THREADS;
      int gr = r0 + (e >> 3), gk = k0 + (e & (DK - 1));
      v[i] = (gr < nrows && gk < d) ? X[(size_t)gr * d + gk] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*S)[ROWS + PAD]) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int e = threadIdx.x + i * THREADS;
      S[e & (DK - 1)][e >> 3] = v[i];
    }
  }
};

// |x|^2 += x * x for four points, one feature.  Rows and columns sum their
// features in the same order with the same FMAs, so a point's norm has the
// same bits whichever operand it belongs to.
__device__ __forceinline__ void add_sq(float (&s)[4], float4 x) {
  s[0] = fmaf(x.x, x.x, s[0]);
  s[1] = fmaf(x.y, x.y, s[1]);
  s[2] = fmaf(x.z, x.z, s[2]);
  s[3] = fmaf(x.w, x.w, s[3]);
}

// One feature of the 4 x 4 micro-tile: acc += a b^T, and the rows' squared
// norms (and the columns', with NORM_B).
template <bool NORM_B>
__device__ __forceinline__ void fma_feature(float (&acc)[4][4], float (&a2)[4],
                                            float (&b2)[4], float4 a,
                                            float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
  add_sq(a2, a);
  if (NORM_B) add_sq(b2, b);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int FORM>
__device__ __forceinline__ void covariance(float (&v)[4][4],
                                           const float (&av)[4],
                                           const float (&bv)[4], float sf2,
                                           float inv_l) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float r2 = fmaxf(fmaf(-2.0f, v[r][c], av[r] + bv[c]), 0.0f);
      v[r][c] = sf2 * radial<FORM>(r2, inv_l);
    }
}

template <bool STREAM>
__device__ __forceinline__ void put4(float* p, float x, float y, float z,
                                     float w) {
  float4 q = make_float4(x, y, z, w);
  if (STREAM) __stcs(reinterpret_cast<float4*>(p), q);
  else *reinterpret_cast<float4*>(p) = q;
}

template <bool STREAM>
__device__ __forceinline__ void put1(float* p, float x) {
  if (STREAM) __stcs(p, x);
  else *p = x;
}

// Store the 4 x 4 micro-tile v at rows R0.., columns C0.. of out (rows,
// cols).  vec: 16-byte stores (cols a multiple of 4, so a column block is
// in or out whole); else one float at a time.
template <bool STREAM>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&v)[4][4], int R0,
                                           int C0, int rows, int cols,
                                           bool vec) {
  if (vec) {
    if (C0 >= cols) return;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (R0 + r < rows)
        put4<STREAM>(out + (size_t)(R0 + r) * cols + C0, v[r][0], v[r][1],
                     v[r][2], v[r][3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (R0 + r < rows && C0 + c < cols)
          put1<STREAM>(out + (size_t)(R0 + r) * cols + C0 + c, v[r][c]);
  }
}

// The same micro-tile transposed, at rows C0.., columns R0.. of the square
// (N, N) out: a thread's 4 x 4 block is its own transpose's.
__device__ __forceinline__ void store_tile_t(float* __restrict__ out,
                                             const float (&v)[4][4], int R0,
                                             int C0, int N, bool vec) {
  float w[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c][r] = v[r][c];
  store_tile<true>(out, w, C0, R0, N, N, vec);
}

// The staged feature slices of one tile.
template <int TM>
struct Smem {
  __align__(16) float As[DK][TM + PAD];
  __align__(16) float Bs[DK][TN + PAD];
};

struct Tile {
  int row0, col0;       // the tile's first output row and column
  bool transpose;       // training: also write the tile transposed
};

// One (TM, TN) output tile of sf2 * rho over X1 rows [row0, row0 + TM) and
// X2 rows [col0, col0 + TN).  TRAIN adds the training epilogue: entries with
// row, col < nvalid hold cov + diag_add * [row == col]; all others hold
// [row == col] (the masked-identity padding).
template <int TM, bool TRAIN, bool MULTI>
__device__ __forceinline__ void tile_body(
    const float* __restrict__ X1, const float* __restrict__ X2, int n, int m,
    int d, float sf2, float inv_l, float dadd, int nvalid, int form,
    float* __restrict__ out, Tile tile, bool vec, Smem<TM>& sm) {
  constexpr int STEPS = TM / 32;
  auto& As = sm.As;
  auto& Bs = sm.Bs;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q = (warp & 3) * 8 + (lane & 7);    // column block: 0..31
  const int pbase = (warp >> 2) * 4 + (lane >> 3);  // row block at step 0
  const int row0 = tile.row0, col0 = tile.col0;

  Slice<TM> sa;
  Slice<TN> sb;
  sa.load(X1, row0, n, d, 0);
  sb.load(X2, col0, m, d, 0);
  sa.store(As);
  sb.store(Bs);
  __syncthreads();

  // one chunk: this thread's four columns and their norms stay in registers
  float4 breg[DK];
  float b2c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    breg[kk] = *reinterpret_cast<const float4*>(&Bs[kk][4 * q]);
    add_sq(b2c, breg[kk]);
  }
  const int C0 = col0 + 4 * q;
  // the epilogue per entry only where a tile meets the diagonal or the
  // padding; elsewhere the entry is the covariance itself
  const bool masked = TRAIN && (row0 == col0 || row0 + TM > nvalid ||
                                col0 + TN > nvalid);

#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    const int p = s * 8 + pbase;
    float v[4][4], a2[4], b2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a2[r] = 0.f;
      b2[r] = MULTI ? 0.f : b2c[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = 0.f;
    }
    if (!MULTI) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        fma_feature<false>(v, a2, b2,
                           *reinterpret_cast<const float4*>(&As[kk][4 * p]),
                           breg[kk]);
    } else {
      for (int k0 = 0; k0 < d; k0 += DK) {
        if (s > 0 || k0 > 0) {
          sa.load(X1, row0, n, d, k0);
          sb.load(X2, col0, m, d, k0);
          __syncthreads();
          sa.store(As);
          sb.store(Bs);
          __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          fma_feature<true>(
              v, a2, b2, *reinterpret_cast<const float4*>(&As[kk][4 * p]),
              *reinterpret_cast<const float4*>(&Bs[kk][4 * q]));
      }
    }
    switch (form) {
      case SE: covariance<SE>(v, a2, b2, sf2, inv_l); break;
      case MATERN32: covariance<MATERN32>(v, a2, b2, sf2, inv_l); break;
      default: covariance<MATERN52>(v, a2, b2, sf2, inv_l); break;
    }
    const int R0 = row0 + 4 * p;
    if (masked) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = R0 + r, col = C0 + c;
          const float dg = row == col ? 1.0f : 0.0f;
          v[r][c] = (row < nvalid && col < nvalid) ? v[r][c] + dadd * dg : dg;
        }
    }
    store_tile<TRAIN>(out, v, R0, C0, n, m, vec);
    if (TRAIN && tile.transpose) store_tile_t(out, v, R0, C0, m, vec);
  }
}

// A training tile wholly in the padding (all its rows at or past nvalid):
// the identity's entries, no arithmetic.
__device__ __forceinline__ void identity_tile(float* __restrict__ out, int N,
                                              Tile tile, bool vec) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q = (warp & 3) * 8 + (lane & 7);
  const int pbase = (warp >> 2) * 4 + (lane >> 3);
  const int C0 = tile.col0 + 4 * q;
#pragma unroll 1
  for (int s = 0; s < TN / 32; ++s) {
    const int R0 = tile.row0 + 4 * (s * 8 + pbase);
    float v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = (R0 + r == C0 + c) ? 1.f : 0.f;
    store_tile<true>(out, v, R0, C0, N, N, vec);
    if (tile.transpose) store_tile_t(out, v, R0, C0, N, vec);
  }
}

template <int TM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gram_kernel(const float* __restrict__ X1, const float* __restrict__ X2,
            int n, int m, int d, const float* __restrict__ sf2_p,
            const float* __restrict__ inv_l_p, int form,
            float* __restrict__ out, bool vec) {
  __shared__ Smem<TM> sm;
  const Tile tile{(int)blockIdx.y * TM, (int)blockIdx.x * TN, false};
  if (d <= DK)
    tile_body<TM, false, false>(X1, X2, n, m, d, *sf2_p, *inv_l_p, 0.f, 0,
                                form, out, tile, vec, sm);
  else
    tile_body<TM, false, true>(X1, X2, n, m, d, *sf2_p, *inv_l_p, 0.f, 0,
                               form, out, tile, vec, sm);
}

// Block b takes the lower-triangle tile (I, J), I >= J, b = I (I + 1) / 2 + J.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gram_train_kernel(const float* __restrict__ X, int N, int d,
                  const float* __restrict__ sf2_p,
                  const float* __restrict__ inv_l_p,
                  const float* __restrict__ dadd_p, int nvalid, int form,
                  float* __restrict__ out, bool vec) {
  __shared__ Smem<TN> sm;
  const int b = blockIdx.x;
  int I = (int)((sqrtf(8.0f * (float)b + 1.0f) - 1.0f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  while (I * (I + 1) / 2 > b) --I;
  const int J = b - I * (I + 1) / 2;
  const Tile tile{I * TN, J * TN, I != J};
  if (tile.row0 >= nvalid) {           // I >= J: every entry is padding
    identity_tile(out, N, tile, vec);
    return;
  }
  if (d <= DK)
    tile_body<TN, true, false>(X, X, N, N, d, *sf2_p, *inv_l_p, *dadd_p,
                               nvalid, form, out, tile, vec, sm);
  else
    tile_body<TN, true, true>(X, X, N, N, d, *sf2_p, *inv_l_p, *dadd_p,
                              nvalid, form, out, tile, vec, sm);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      sms = 132;
  }
  return sms;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (n, m) = sf2 * rho(X1 (n, d), X2 (m, d)); sf2 and inv_l are device
// scalars so that the caller never waits on the card for them.  128-row
// tiles, or 32-row tiles where 128-row ones would give the card fewer than
// two blocks an SM.
int gram_launch(const float* X1, const float* X2, int n, int m, int d,
                const float* sf2, const float* inv_l, int form, float* out,
                void* stream) {
  const bool vec = (m % 4 == 0) && aligned16(out);
  const int cols = (m + TN - 1) / TN;
  const long tiles128 = (long)cols * ((n + 127) / 128);
  if (tiles128 >= 2L * sm_count()) {
    dim3 grid(cols, (n + 127) / 128);
    gram_kernel<128><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        X1, X2, n, m, d, sf2, inv_l, form, out, vec);
  } else {
    dim3 grid(cols, (n + 31) / 32);
    gram_kernel<32><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        X1, X2, n, m, d, sf2, inv_l, form, out, vec);
  }
  return (int)cudaGetLastError();
}

// out (N, N): the padded training covariance of X (N, d) with nvalid valid
// rows (limbo_tpu/ops/gram_pallas.py _gram_train_kernel), one block per
// lower-triangle 128 x 128 tile.
int gram_train_launch(const float* X, int N, int d, const float* sf2,
                      const float* inv_l, const float* diag_add, int nvalid,
                      int form, float* out, void* stream) {
  const bool vec = (N % 4 == 0) && aligned16(out);
  const int T = (N + TN - 1) / TN;
  const int blocks = T * (T + 1) / 2;
  gram_train_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      X, N, d, sf2, inv_l, diag_add, nvalid, form, out, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
