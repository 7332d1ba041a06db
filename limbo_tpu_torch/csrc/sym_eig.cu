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
// Algorithm: cyclic-by-row Jacobi with a fixed number of sweeps (no
// convergence test, so no data-dependent exit), then the eigenvalues sorted
// ascending (a stable insertion sort) and each eigenvector's entry of
// largest magnitude made positive.  `sym_eig_plain` in ops/sym_eig.py does
// the same rotations in the same order, so the two agree to rounding.
// Rotation (p, q): theta = (a_qq - a_pp) / (2 a_pq),
// t = sign(theta) / (|theta| + hypot(theta, 1)) (t = 0 when a_pq = 0),
// c = 1 / sqrt(t^2 + 1), s = t c; a_pp -= t a_pq, a_qq += t a_pq,
// a_pq = 0, and rows / columns r != p, q and the eigenvector columns turn
// by (c, s).
//
// Bound on the H100: neither bytes nor operations.  The CMA-ES covariances
// are (restarts, d, d) with d <= 8: a few hundred bytes and ~50k flops a
// call.  It is a chain of d(d-1)/2 dependent rotations per sweep, each a
// few shared-memory reads and a barrier: bound by that latency.  One warp
// per matrix holds the matrix and its eigenvectors in shared memory; lane r
// turns row and column r of each rotation, so a rotation is one step of
// the warp and a __syncwarp.

#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 32;

template <typename T>
__device__ __forceinline__ T hypot_t(T a, T b);
template <>
__device__ __forceinline__ float hypot_t<float>(float a, float b) {
  return hypotf(a, b);
}
template <>
__device__ __forceinline__ double hypot_t<double>(double a, double b) {
  return hypot(a, b);
}

template <typename T>
__global__ void __launch_bounds__(32)
sym_eig_kernel(const T* __restrict__ A, int d, int sweeps, T* __restrict__ w,
               T* __restrict__ V) {
  __shared__ T a[MAXD][MAXD + 1];
  __shared__ T v[MAXD][MAXD + 1];
  __shared__ int order[MAXD];
  const int r = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * d * d;
  if (r < d) {
    for (int k = 0; k < d; ++k) {
      a[r][k] = A[base + (size_t)r * d + k];
      v[r][k] = (r == k) ? T(1) : T(0);
    }
  }
  __syncwarp();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int p = 0; p < d - 1; ++p) {
      for (int q = p + 1; q < d; ++q) {
        const T apq = a[p][q];
        const T app = a[p][p];
        const T aqq = a[q][q];
        T t = T(0);
        if (apq != T(0)) {
          const T theta = (aqq - app) / (T(2) * apq);
          const T sgn = theta >= T(0) ? T(1) : T(-1);
          t = sgn / (fabs(theta) + hypot_t<T>(theta, T(1)));
        }
        const T c = T(1) / sqrt(t * t + T(1));
        const T s = t * c;
        __syncwarp();
        if (r < d) {
          if (r != p && r != q) {
            const T arp = a[r][p];
            const T arq = a[r][q];
            const T np = c * arp - s * arq;
            const T nq = s * arp + c * arq;
            a[r][p] = np;
            a[r][q] = nq;
            a[p][r] = np;
            a[q][r] = nq;
          }
          const T vrp = v[r][p];
          const T vrq = v[r][q];
          v[r][p] = c * vrp - s * vrq;
          v[r][q] = s * vrp + c * vrq;
        }
        __syncwarp();
        if (r == 0) {
          a[p][p] = app - t * apq;
          a[q][q] = aqq + t * apq;
          a[p][q] = T(0);
          a[q][p] = T(0);
        }
        __syncwarp();
      }
    }
  }
  // ascending eigenvalues, stable: equal values keep their index order
  if (r == 0) {
    for (int j = 0; j < d; ++j) order[j] = j;
    for (int j = 1; j < d; ++j) {
      const int oj = order[j];
      const T key = a[oj][oj];
      int i = j - 1;
      while (i >= 0 && a[order[i]][order[i]] > key) {
        order[i + 1] = order[i];
        --i;
      }
      order[i + 1] = oj;
    }
  }
  __syncwarp();
  if (r < d) {
    const int col = order[r];
    w[(size_t)blockIdx.x * d + r] = a[col][col];
    // the first entry of largest magnitude is made positive
    int im = 0;
    T big = fabs(v[0][col]);
    for (int k = 1; k < d; ++k) {
      const T m = fabs(v[k][col]);
      if (m > big) {
        big = m;
        im = k;
      }
    }
    const T sg = v[im][col] < T(0) ? T(-1) : T(1);
    for (int k = 0; k < d; ++k) V[base + (size_t)k * d + r] = sg * v[k][col];
  }
}

}  // namespace

extern "C" {

const char* limbo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A (batch, d, d) symmetric, row-major -> w (batch, d) ascending and
// V (batch, d, d) with the eigenvector of w[., j] in column j; f64 when
// is_double != 0, else f32.  d <= 32.
int sym_eig_launch(const void* A, int batch, int d, int sweeps,
                   int is_double, void* w, void* V, void* stream) {
  if (d < 1 || d > MAXD || batch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    sym_eig_kernel<double><<<batch, 32, 0, s>>>(
        (const double*)A, d, sweeps, (double*)w, (double*)V);
  } else {
    sym_eig_kernel<float><<<batch, 32, 0, s>>>(
        (const float*)A, d, sweeps, (float*)w, (float*)V);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
