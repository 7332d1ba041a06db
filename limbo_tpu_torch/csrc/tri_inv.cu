// Inverses of the diagonal blocks of a lower-triangular matrix, for Hopper
// (sm_90a).  Built into a shared library with a plain C interface and bound
// with ctypes (limbo_tpu_torch/ops/chol.py: _tri_inv_panel).
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
// inverses out: ~7.9 MB at N = 10240, ~13 MB at 16896, ~2.3 / ~3.9 us at
// 3.35 TB/s) and the ~B^3/3 flops a block (~0.8 / ~1.4 us at 67 TFLOP/s)
// are small; what costs is the chain of dependent steps inside one block.
// A block runs on one SM and the grid has 80 blocks at N = 10240 (132 at
// 16896) for 132 SMs, so every block has an SM to itself and the kernel
// takes as long as one block's chain.  Splitting a diagonal block over
// several SMs would need their shared memories joined for every merge
// below; instead the block has 256 threads (8 warps, two a scheduler), so
// that a warp stalled on a shared-memory load leaves another to issue.
//
// Design.  The 128-long chain of forward substitution is cut into 32-wide
// pieces: with L given, the inverses of its four 32 x 32 diagonal
// sub-blocks are independent, and the rest of X = L^{-1} follows from them
// by products:
//   1. load: every thread issues all of its global loads (16-byte loads of
//      the lower triangle; the chunk that holds the diagonal element by
//      scalar loads of the entries on and below it, so nothing above the
//      diagonal is read) before its first shared-memory write.  L and X
//      stay resident in shared memory, rows padded to 132 floats, so rows
//      stay 16-byte aligned and the rows a warp reads at one column fall 4
//      banks apart;
//   2. diagonal sub-inverses: warps 0 to 3 invert the four 32 x 32
//      diagonal sub-blocks at the same time, in registers: lane c owns
//      column c and substitutes down it, four columns of L at a time, each
//      row of them one 16-byte shared-memory broadcast; the diagonal's
//      correctly rounded reciprocals (__frcp_rn) are taken first, one a
//      lane, off the chain;
//   3. merges by recursive doubling: for the two 64 x 64 halves at once
//      (threads 0-63 and 64-127), X21 = -X22 (L21 X11) with 32 x 32 blocks;
//      then for the whole block, with 64 x 64 halves, on all 8 warps, each
//      product split along the zero block of X11 or X22 into one of depth
//      64 and one of depth 32, run together.  Each product is a
//      shared-memory GEMM on the CUDA cores, a thread a 4 x 4 register
//      tile, A read four deep and B along its row as float4.  Block-row
//      substitution (the panel kernel's order) takes 3 dependent rounds of
//      two products on at most 192 threads; recursive doubling takes 2
//      rounds, the second on all 256.  6 block barriers in all;
//   4. store: 16-byte streaming stores of whole rows; every entry above
//      the diagonal is written as 0.0, whatever shared memory holds there.
// f32 in IEEE arithmetic on the CUDA cores throughout (no TF32), in a fixed
// order: every launch gives the same bits.  A zero on the diagonal gives
// inf and NaN in its own block only.
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_tri_inv_split.py,
// clock64() stamps in a patched copy), N = 10240 [16896]: 0.0113 [0.0118]
// ms a call, against 0.0800 for the earlier design (one thread
// substituting down each column: 193,927 cycles a block, 0.902 of them the
// substitution chain).  17,477 [18,226] cycles a block, 8.8 us of the
// 11.3, the rest the launch and the grid's start and end: load 4,619
// (0.264), diagonal sub-inverses 2,260 (0.129), merges of 64 2,508
// (0.144), merge of 128 5,965 (0.341), store issue 2,125 (0.122).
// Block-row substitution was not built: the panel kernel assembles the
// same inverse in that order and spends 18,831 cycles on it
// (csrc/panel_factor.cu), against 8,473 for the merges here.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128;            // ops/chol.py TRI_INV_BLOCK
constexpr int W = 32;             // diagonal sub-block: one warp's width
constexpr int NT = 256;           // threads
constexpr int LD = B + 4;   // padded rows of L, X and T, 16-byte aligned
constexpr int SLOTS = B * (B / 4) / NT;   // float4 slots of a block a thread
constexpr int SMEM = (2 * B + B / 2) * LD * (int)sizeof(float);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// C = alpha A Bm for an M x N output of depth K (multiples of 4), all three
// in shared memory with row stride LD.  Thread g of the calling group takes
// the 4 x 4 tile at rows ti + s M/4 and columns 4 tj + u; threads past the
// M N / 16 tiles do nothing.
template <int M, int N, int K>
__device__ __forceinline__ void tile_mm(const float* A, const float* Bm,
                                        float* C, float alpha, int g) {
  constexpr int MT = M / 4, NT4 = N / 4;
  if (g >= MT * NT4) return;
  const int ti = g / NT4, tj = g % NT4;
  float c[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int u = 0; u < 4; ++u) c[s][u] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) a[s] = ld4(A + (ti + s * MT) * LD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = ld4(Bm + (k + kk) * LD + 4 * tj);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float av = part(a[s], kk);
        c[s][0] = fmaf(av, b.x, c[s][0]);
        c[s][1] = fmaf(av, b.y, c[s][1]);
        c[s][2] = fmaf(av, b.z, c[s][2]);
        c[s][3] = fmaf(av, b.w, c[s][3]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
    st4(C + (ti + s * MT) * LD + 4 * tj,
        make_float4(alpha * c[s][0], alpha * c[s][1], alpha * c[s][2],
                    alpha * c[s][3]));
}

// One warp: X[j0:j0+W, j0:j0+W] = L[j0:j0+W, j0:j0+W]^{-1}, lane c computing
// column c by column-oriented substitution (x_m *= 1 / L_mm, then
// x_r -= L_rm x_m for r > m, m ascending); zeros above the diagonal.  The
// columns of L are taken four at a time: one 16-byte broadcast read of a
// row gives L_rm for four m, and Rs the diagonal's reciprocals, taken
// first, one a lane: each __frcp_rn is a sequence of instructions, and on
// one lane at a time 32 of them would run one after another.
__device__ __forceinline__ void invert_diag(const float* Ls, float* Rs,
                                            float* Xs, int j0, int lane) {
  Rs[j0 + lane] = __frcp_rn(Ls[(j0 + lane) * LD + j0 + lane]);
  __syncwarp();
  float x[W];
#pragma unroll
  for (int r = 0; r < W; ++r) x[r] = r == lane ? 1.f : 0.f;
#pragma unroll
  for (int m0 = 0; m0 < W; m0 += 4) {
    const float* Lm = Ls + j0 * LD + j0 + m0;
    const float4 rcp = ld4(Rs + j0 + m0);
    float4 d[4];   // rows m0+1 .. m0+3 of the 4 x 4 diagonal mini-block
#pragma unroll
    for (int a = 1; a < 4; ++a) d[a] = ld4(Lm + (m0 + a) * LD);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[m0 + a] *= part(rcp, a);
#pragma unroll
      for (int b = a + 1; b < 4; ++b)
        x[m0 + b] = fmaf(-part(d[b], a), x[m0 + a], x[m0 + b]);
    }
#pragma unroll
    for (int r = m0 + 4; r < W; ++r) {
      const float4 l = ld4(Lm + r * LD);
      x[r] = fmaf(-l.x, x[m0], x[r]);
      x[r] = fmaf(-l.y, x[m0 + 1], x[r]);
      x[r] = fmaf(-l.z, x[m0 + 2], x[r]);
      x[r] = fmaf(-l.w, x[m0 + 3], x[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < W; ++r)
    Xs[(j0 + r) * LD + j0 + lane] = r >= lane ? x[r] : 0.f;
}

__global__ void __launch_bounds__(NT, 1)
tri_inv_panel_kernel(const float* __restrict__ L, int N,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;            // (B, LD) lower triangle of the block
  float* Xs = Ls + B * LD;     // (B, LD) its inverse
  float* Ts = Xs + B * LD;     // (B/2, LD) a merge's partial product
  __shared__ __align__(16) float Rs[B];   // 1 / L_rr, correctly rounded
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const float* Lb = L + (size_t)blockIdx.x * B * N + (size_t)blockIdx.x * B;

  // 1. load: slot i of a thread is row warp + 8 i, columns 4 lane .. +3
  float4 v[SLOTS];
  const int c = 4 * lane;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int r = warp + 8 * i;
    const float* p = Lb + (size_t)r * N + c;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c + 3 <= r) {
      q = __ldg(reinterpret_cast<const float4*>(p));
    } else if (c <= r) {   // the diagonal's chunk: entries c .. r only
      q.x = __ldg(p);
      if (c + 1 <= r) q.y = __ldg(p + 1);
      if (c + 2 <= r) q.z = __ldg(p + 2);
    }
    v[i] = q;
  }
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) st4(Ls + (warp + 8 * i) * LD + c, v[i]);
  __syncthreads();

  // 2. the four diagonal sub-inverses, one warp each, at the same time
  if (warp < B / W) invert_diag(Ls, Rs, Xs, W * warp, lane);
  __syncthreads();

  // 3a. the two 64 x 64 halves h at once: X21 = -X22 (L21 X11)
  if (t < 128) {
    const int h = t >> 6, g = t & 63, o = 2 * W * h;
    tile_mm<W, W, W>(Ls + (o + W) * LD + o, Xs + o * LD + o, Ts + W * h, 1.f,
                     g);
  }
  __syncthreads();
  if (t < 128) {
    const int h = t >> 6, g = t & 63, o = 2 * W * h;
    tile_mm<W, W, W>(Xs + (o + W) * LD + o + W, Ts + W * h,
                     Xs + (o + W) * LD + o, -1.f, g);
  }
  __syncthreads();
  // 3b. the whole block, halves of 64: X21 = -X22 (L21 X11).  X11 and X22
  // are lower block-triangular, so each product is two at once, one of
  // depth 64 (threads 0-127) and one of depth 32 (threads 128-255), a
  // scheduler holding a warp of each: T = L21 X11 by column blocks, then
  // X21 = -X22 T by row blocks
  if (t < 128)
    tile_mm<2 * W, W, 2 * W>(Ls + 2 * W * LD, Xs, Ts, 1.f, t);
  else
    tile_mm<2 * W, W, W>(Ls + 2 * W * LD + W, Xs + W * LD + W, Ts + W, 1.f,
                         t - 128);
  __syncthreads();
  if (t < 128)
    tile_mm<W, 2 * W, 2 * W>(Xs + 3 * W * LD + 2 * W, Ts, Xs + 3 * W * LD,
                             -1.f, t);
  else
    tile_mm<W, 2 * W, W>(Xs + 2 * W * LD + 2 * W, Ts, Xs + 2 * W * LD, -1.f,
                         t - 128);
  __syncthreads();

  // 4. store, zero above the diagonal
  float* Ob = out + (size_t)blockIdx.x * B * B;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int r = warp + 8 * i;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c <= r) {
      q = ld4(Xs + r * LD + c);
      if (c + 1 > r) q.y = 0.f;
      if (c + 2 > r) q.z = 0.f;
      if (c + 3 > r) q.w = 0.f;
    }
    __stcs(reinterpret_cast<float4*>(Ob + r * B + c), q);
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (N/128, 128, 128): the inverse of each (128, 128) diagonal block of
// L (N, N), row-major, read from the lower triangles of those blocks only.
// N must be a multiple of 128 (the wrapper checks).  The shared-memory
// opt-in is asked for once a process.
int tri_inv_panel_launch(const float* L, int N, float* out, void* stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      tri_inv_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (set != cudaSuccess) return (int)set;
  tri_inv_panel_kernel<<<N / B, NT, SMEM, (cudaStream_t)stream>>>(L, N, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
