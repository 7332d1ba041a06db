// Batched symmetric eigensolver for Hopper (sm_90a): the eigenvalues and
// eigenvectors of a batch of small symmetric matrices (d <= 32), with no
// read-back to the host, so that it runs inside a captured CUDA graph.
// Built into a shared library with a plain C interface and bound with
// ctypes (limbo_tpu_torch/ops/sym_eig.py).
//
// The port's own kernel.  It replaces the `jnp.linalg.eigh(C)` of each
// CMA-ES generation (limbo_tpu/opt/cmaes.py:93), which the reference leaves
// to XLA: `torch.linalg.eigh` on a CUDA tensor checks its solver's `info` on
// the host, which a captured BO iteration cannot do.
//
// Algorithm: parallel-ordered Jacobi (ops/sym_eig.py's module docstring
// states it; `sym_eig_plain` there does the same rotations in the same
// order, so the two agree to rounding).  A d x d matrix is zero-padded to
// D slots (d rounded up to even up to 8, then 16 or 32).  A sweep is D - 1
// rounds of the round-robin ordering: each round turns the D / 2 disjoint
// pairs (2k, 2k+1) of slots at once, every pair's (c, s) computed from the
// matrix as it was at the start of the round, then the columns of A and V
// turned, then the rows of A, then the pairs' own entries set
// (a_pp -= t a_pq, a_qq += t a_pq, a_pq = a_qp = 0).  Between rounds the
// contents of the slots move by the circle method's fixed permutation
// (`sigma`), so every pair of indices meets once a sweep and the slots
// come back after it.  Before each sweep a matrix is done once its
// off-diagonal mass is at most (u ||diag||)^2 (u the working type's unit
// roundoff, the sums in f64), and a pair with |a_pq| <= u ||diag|| is not
// turned (its a_pq is set to zero).  Then the eigenvalues are ranked
// (stable, ascending) and each eigenvector's entry of largest magnitude
// made positive.
//
// Bound on the H100: neither bytes nor operations.  The CMA-ES covariances
// are (restarts, d, d) with d <= 8: a few hundred bytes and a few thousand
// flops a call.  Time goes to the chain of dependent rounds: each needs the
// pairs' entries from other lanes, a hypot, a division and an rsqrt, the
// rows of the partner lanes, and the next round's entries from the result.
// The design shortens that chain:
// - one round turns D / 2 pairs at once: d - 1 dependent rounds a sweep
//   at even d (5 at d = 6) where cyclic Jacobi has d (d - 1) / 2 rotations;
// - a matrix is held a row a lane in registers (W lanes a matrix, W the
//   power of two >= D, 32 / W matrices a warp); every loop over D is
//   unrolled at compile time, so the slots are registers and the
//   permutation between rounds is a renaming within a lane plus one
//   shuffle a row, fused with the row rotation;
// - each lane computes its own pair's (t, c, s) from three shuffled
//   values (both lanes of a pair the same bits), turns its own rows'
//   columns with every pair's (c, s) shuffled from the pair's first lane,
//   and reads the partner rows with shuffles: no shared-memory round trip
//   and no barrier inside a sweep;
// - the rotation's divisions and square roots are the hardware's
//   approximations with Newton steps, without branches, and every runtime
//   index goes through a shuffle or a tree of selects, so the round is one
//   basic block with a and v in registers (an indexed select chain had
//   put the pairs' values in local memory, and IEEE division's slow-path
//   branch had split the round);
// - the sweeps stop at the convergence rule, tested warp-uniformly;
// - shared memory only holds the epilogue, where each lane ranks and signs
//   its own eigenvector in parallel.
// Its latency floor (chip_smoke.py's sym_eig_entry) is the launch floor
// plus the sweeps a matrix needs times one sweep of this design, timed on
// the card as the difference of launches capped at one sweep and at none
// (the `sweeps` argument).

#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Unit;
template <>
struct Unit<float> {
  static constexpr double u = 5.9604644775390625e-08;  // 2^-24
};
template <>
struct Unit<double> {
  static constexpr double u = 1.1102230246251565e-16;  // 2^-53
};

// Branch-free reciprocal and reciprocal square root: the hardware's
// approximations (flushing subnormals), refined by Newton steps where the
// precision is needed.  CUDA's IEEE division, hypot and rsqrt each branch
// to a slow path for special operands, and those branches split the
// round into many basic blocks.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rcp_approx(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rsqrt_approx(double x) {
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
}

// `steps` Newton steps on the approximations: the rotation's t needs none
// in f32 (the approximation's 2^-23 moves a pair's zeroed entry by less
// than f32's rounding of it) and two in f64 (from ~2^-22 to past 2^-53);
// c needs one in f32, so that c^2 + s^2 = 1 to rounding and V stays
// orthogonal over hundreds of rotations
template <typename T>
__device__ __forceinline__ T rcp_t(T x, int steps) {
  T r = rcp_approx(x);
#pragma unroll
  for (int i = 0; i < steps; ++i) r = fma(r, fma(-x, r, T(1)), r);
  return r;
}

template <typename T>
__device__ __forceinline__ T rsqrt_t(T x, int steps) {
  T r = rsqrt_approx(x);
#pragma unroll
  for (int i = 0; i < steps; ++i)
    r = fma(T(0.5) * r, fma(-x * r, r, T(1)), r);
  return r;
}

// where the content of slot s goes after a round (ops/sym_eig.py's _sigma)
__host__ __device__ constexpr int sigma(int s, int D) {
  return (D == 2 || s == 0) ? s
         : (s % 2 == 0)     ? (s < D - 2 ? s + 2 : D - 1)
                            : (s > 1 ? s - 2 : 2);
}

// the slot whose content comes to slot t (t >= D: idle lanes stay)
__device__ __forceinline__ int sigma_inv(int t, int D) {
  if (D == 2 || t == 0 || t >= D) return t;
  if (t == 2) return 1;
  if (t == D - 1) return D - 2;
  return (t & 1) ? t + 2 : t - 2;
}

// lanes a matrix: the power of two >= D
__host__ __device__ constexpr int group_width(int D) {
  return D <= 2 ? 2 : D <= 4 ? 4 : D <= 8 ? 8 : D <= 16 ? 16 : 32;
}

// x[i] for a runtime i, as a tree of selects on i's bits (a dynamic index
// would put x in local memory); 0 when i >= D
template <int D, typename T>
__device__ __forceinline__ T pick(const T (&x)[D], int i) {
  T y[D];
#pragma unroll
  for (int j = 0; j < D; ++j) y[j] = x[j];
#pragma unroll
  for (int w = 1; w < D; w <<= 1) {
#pragma unroll
    for (int j = 0; j + w < D; j += 2 * w) y[j] = (i & w) ? y[j + w] : y[j];
  }
  return i < D ? y[0] : T(0);
}

// The rotation (t, c, s) that zeroes a_pq, t = 0 and c = 1 (the
// identity) if the matrix is done or |a_pq| <= tau: t = sign(phi a_pq)
// |a_pq| / (|phi| + hypot(phi, a_pq)), phi = (a_qq - a_pp) / 2, evaluated
// on (phi, a_pq) scaled by 1 / max(|phi|, |a_pq|) (so that the sum of
// squares lies in [1, 2] and the divisor in [1, 1 + sqrt 2]: no special
// operand), c = 1 / sqrt(1 + t^2), s = t c.
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T tau,
                                         bool done, T& t, T& c, T& s) {
  constexpr bool f64 = sizeof(T) == 8;
  const int steps = f64 ? 2 : 0;
  const T tiny = f64 ? T(2.2250738585072014e-308) : T(1.17549435e-38f);
  const T phi = T(0.5) * (aqq - app);
  const T r = rcp_t(fmax(fmax(fabs(phi), fabs(apq)), tiny), steps);
  const T p = phi * r, q = apq * r;
  const T h2 = fma(p, p, q * q);
  const T den = fabs(p) + h2 * rsqrt_t(h2, steps);
  const T num = (phi * apq >= T(0)) ? fabs(q) : -fabs(q);
  t = (!done && fabs(apq) > tau) ? num * rcp_t(den, steps) : T(0);
  const T cr = rsqrt_t(fma(t, t, T(1)), f64 ? 2 : 1);
  c = t == T(0) ? T(1) : cr;
  s = t * c;
}

// One round on the matrix held in the W lanes of this lane's group (lane t
// holds slot t's row of A and row t of V, columns in slot order).  Each
// lane computes the rotation of its own pair (slots t & ~1 and t | 1) from
// the pair's entries at the round's start, shuffled from the pair's
// lanes, and its slot's new diagonal; the columns of its rows are turned
// by every pair's (c, s), shuffled from each pair's first lane; then it
// takes the row of slot u (whose content comes here) turned with its
// partner's, with slot u's (c, s) and new diagonal shuffled from lane u,
// the pair's own entries set unless the matrix is done, and the columns
// moved to their next slots.  Every index into a and v is known at
// compile time (the loops over D unrolled), so both stay in registers;
// the runtime indices go through shuffles and selects only.
template <typename T, int D>
__device__ __forceinline__ void jacobi_round(T (&a)[D], T (&v)[D], int t,
                                             int u, T tau, bool done) {
  constexpr int W = group_width(D);
  const T dg = pick<D>(a, t);
  const T of = pick<D>(a, t ^ 1);
  const int p = t & ~1;
  const T app = __shfl_sync(FULL, dg, p, W);
  const T aqq = __shfl_sync(FULL, dg, p | 1, W);
  const T apq = __shfl_sync(FULL, of, p, W);
  T tk, c, s;
  rotation(app, aqq, apq, tau, done, tk, c, s);
  const T dn = (t & 1) ? aqq + tk * apq : app - tk * apq;
#pragma unroll
  for (int k = 0; k < D / 2; ++k) {
    const T ck = __shfl_sync(FULL, c, 2 * k, W);
    const T sk = __shfl_sync(FULL, s, 2 * k, W);
    const T a0 = a[2 * k], a1 = a[2 * k + 1];
    a[2 * k] = ck * a0 - sk * a1;
    a[2 * k + 1] = sk * a0 + ck * a1;
    const T v0 = v[2 * k], v1 = v[2 * k + 1];
    v[2 * k] = ck * v0 - sk * v1;
    v[2 * k + 1] = sk * v0 + ck * v1;
  }
  const T cu = __shfl_sync(FULL, c, u, W);
  const T sv = __shfl_sync(FULL, s, u, W);
  const T su = (u & 1) ? sv : -sv;
  const T du = __shfl_sync(FULL, dn, u, W);
  T nxt[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const T x = __shfl_sync(FULL, a[j], u, W);
    const T y = __shfl_sync(FULL, a[j], u ^ 1, W);
    const T e = cu * x + su * y;
    nxt[sigma(j, D)] = done ? e : (j == u) ? du : (j == (u ^ 1)) ? T(0) : e;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = nxt[j];
#pragma unroll
  for (int j = 0; j < D; ++j) nxt[sigma(j, D)] = v[j];
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = nxt[j];
}

template <typename T, int D>
__global__ void __launch_bounds__(32)
sym_eig_kernel(const T* __restrict__ A, int batch, int d, int max_sweeps,
               T* __restrict__ w_out, T* __restrict__ V_out,
               int* __restrict__ sweeps_out) {
  constexpr int W = group_width(D);
  constexpr int G = 32 / W;
  __shared__ T sm[G][D][D + 1];
  const int lane = threadIdx.x;
  const int g = lane / W;
  const int t = lane % W;  // this lane's slot (idle when t >= D)
  const long long m = (long long)blockIdx.x * G + g;
  const bool live = m < batch;
  const long long dd = (long long)d * d;

  // a row a lane, straight from memory (the matrix's few hundred bytes
  // share a handful of sectors); padding is zero
  const T* row = A + m * dd + (long long)t * d;
  T a[D], v[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    a[j] = (live && t < d && j < d) ? row[j] : T(0);
    v[j] = (j == t) ? T(1) : T(0);
  }

  const int u = sigma_inv(t, D);  // the slot whose row comes here
  const double uu = Unit<T>::u;
  int sweeps = 0;  // the sweeps this lane's matrix took
  for (int sweep = 0;; ++sweep) {
    // the rule, over the matrix's W lanes (identical sums in every lane)
    double off2 = 0.0, dg2 = 0.0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const double x = (double)a[j];
      dg2 = j == t ? x * x : dg2;
      off2 = j == t ? off2 : fma(x, x, off2);
    }
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      off2 += __shfl_xor_sync(FULL, off2, o, W);
      dg2 += __shfl_xor_sync(FULL, dg2, o, W);
    }
    const bool done = off2 <= uu * uu * dg2;
    if (sweep == max_sweeps || !__any_sync(FULL, !done)) break;
    sweeps += !done;
    // u ||diag|| (to the approximation's 2^-22: a threshold), without the
    // branches of sqrt
    const T tau = dg2 > 0.0 ? (T)(uu * dg2 * rsqrt_approx(dg2)) : T(0);

    if constexpr (D <= 8) {
#pragma unroll
      for (int r = 0; r < D - 1; ++r)
        jacobi_round<T, D>(a, v, t, u, tau, done);
    } else {
#pragma unroll 1
      for (int r = 0; r < D - 1; ++r)
        jacobi_round<T, D>(a, v, t, u, tau, done);
    }
  }

  // eigenvalue t and eigenvector column t through shared memory (each
  // lane's row of V, its diagonal in the padding column), then each lane
  // ranks its eigenvalue (stable, ascending, NaN last) and signs its column
  const T dg = pick<D>(a, t);
  if (t < D) {
#pragma unroll
    for (int j = 0; j < D; ++j) sm[g][t][j] = v[j];
    sm[g][t][D] = dg;
  }
  __syncwarp();
  if (sweeps_out != nullptr && live && t == 0) sweeps_out[m] = sweeps;
  if (live && t < d) {
    const bool nan_t = dg != dg;
    int rank = 0;
    T big = T(-1), at = T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T wj = sm[g][j][D];
      const bool nan_j = wj != wj;
      const bool less = (wj < dg) || (!nan_j && nan_t);
      const bool same = (wj == dg) || (nan_j && nan_t);
      rank += (j < d) && (less || (same && j < t));
      const T x = sm[g][j][t];
      const bool first = j < d && fabs(x) > big;
      at = first ? x : at;
      big = first ? fabs(x) : big;
    }
    const T sg = at < T(0) ? T(-1) : T(1);
    w_out[m * d + rank] = dg;
#pragma unroll
    for (int r = 0; r < D; ++r) {
      if (r < d) V_out[m * dd + (long long)r * d + rank] = sg * sm[g][r][t];
    }
  }
}

template <typename T, int D>
void launch_d(const void* A, int batch, int d, int sweeps, void* w,
              void* V, int* taken, cudaStream_t s) {
  constexpr int G = 32 / group_width(D);
  sym_eig_kernel<T, D><<<(batch + G - 1) / G, 32, 0, s>>>(
      (const T*)A, batch, d, sweeps, (T*)w, (T*)V, taken);
}

template <typename T>
void launch_t(const void* A, int batch, int d, int sweeps, void* w,
              void* V, int* taken, cudaStream_t s) {
  if (d <= 2) {
    launch_d<T, 2>(A, batch, d, sweeps, w, V, taken, s);
  } else if (d <= 4) {
    launch_d<T, 4>(A, batch, d, sweeps, w, V, taken, s);
  } else if (d <= 6) {
    launch_d<T, 6>(A, batch, d, sweeps, w, V, taken, s);
  } else if (d <= 8) {
    launch_d<T, 8>(A, batch, d, sweeps, w, V, taken, s);
  } else if (d <= 16) {
    launch_d<T, 16>(A, batch, d, sweeps, w, V, taken, s);
  } else {
    launch_d<T, 32>(A, batch, d, sweeps, w, V, taken, s);
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A (batch, d, d) symmetric, row-major -> w (batch, d) ascending and
// V (batch, d, d) with the eigenvector of w[., j] in column j; f64 when
// is_double != 0, else f32.  d <= 32; at most `sweeps` sweeps.  `taken`
// (int (batch,), or null) receives the sweeps each matrix took.
int sym_eig_launch(const void* A, int batch, int d, int sweeps,
                   int is_double, void* w, void* V, void* taken,
                   void* stream) {
  if (d < 1 || d > MAXD || batch < 1 || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    launch_t<double>(A, batch, d, sweeps, w, V, (int*)taken, s);
  } else {
    launch_t<float>(A, batch, d, sweeps, w, V, (int*)taken, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
