// Exact 2-D Expected Hypervolume Improvement + MC estimator (host native).
//
// Capability parity with the reference's compiled EHVI library
// (reference: src/ehvi/ehvi_calculations.cc ehvi2d, ehvi_montecarlo.cc),
// implemented from scratch via the stripe decomposition documented in
// limbo_tpu_torch/ops/ehvi.py (same closed form as the device kernel — the two
// implementations cross-validate each other in tests).  Maximization.
//
// C ABI:
//   void lt_ehvi2d_batch(const double* mu, const double* sigma, int n_cand,
//                        const double* front, int k, const double* ref,
//                        double* out);
//   double lt_ehvi_mc(const double* mu, const double* sigma, int d,
//                     const double* front, int k, const double* ref,
//                     int n_samples, unsigned long long seed);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>
#include <limits>

namespace {

constexpr double kInvSqrt2Pi = 0.3989422804014327;
constexpr double kSqrt2 = 1.4142135623730951;

inline double pdf(double z) { return std::exp(-0.5 * z * z) * kInvSqrt2Pi; }
inline double cdf(double z) { return 0.5 * std::erfc(-z / kSqrt2); }
// integral_{-inf}^{t} (b - y) N(y; mu, s) dy
inline double psi(double b, double t, double mu, double s) {
  const double z = (t - mu) / s;
  return s * pdf(z) + (b - mu) * cdf(z);
}

// minimization-convention exact 2-D EHVI; front sorted ascending in obj0,
// obj1 descending, all strictly inside the ref box.
double ehvi2d_min(double mu1, double mu2, double s1, double s2,
                  const std::vector<double>& a, const std::vector<double>& b,
                  double r1, double r2) {
  const int k = static_cast<int>(a.size());
  s1 = std::max(s1, 1e-12);
  s2 = std::max(s2, 1e-12);
  // stripes i = 1..k+1 with a_0 = -inf, a_{k+1} = r1, b_0 = r2
  // suffix_i = sum_{j=i+1}^{k+1} (a_j - a_{j-1}) psi2(b_{j-1})
  std::vector<double> psi2(k + 1);
  psi2[0] = psi(r2, r2, mu2, s2);
  for (int i = 1; i <= k; ++i) psi2[i] = psi(b[i - 1], b[i - 1], mu2, s2);
  std::vector<double> width(k + 1);  // width_j for j = 2..k+1 used
  for (int j = 2; j <= k + 1; ++j) {
    const double hi = (j <= k) ? a[j - 1] : r1;
    width[j - 1] = hi - a[j - 2];
  }
  double suffix = 0.0;
  std::vector<double> suffix_excl(k + 1, 0.0);
  for (int i = k + 1; i >= 1; --i) {
    suffix_excl[i - 1] = suffix;
    if (i >= 2) suffix += width[i - 1] * psi2[i - 1];
  }
  double total = 0.0;
  double cdf_lo = 0.0;  // Phi(-inf)
  double a_lo = -std::numeric_limits<double>::infinity();
  for (int i = 1; i <= k + 1; ++i) {
    const double a_hi = (i <= k) ? a[i - 1] : r1;
    const double cdf_hi = cdf((a_hi - mu1) / s1);
    const double psi_full = psi(a_hi, a_hi, mu1, s1);
    const double psi_trunc = std::isinf(a_lo)
                                 ? 0.0
                                 : psi(a_hi, a_lo, mu1, s1);
    total += (psi_full - psi_trunc) * psi2[i - 1]
             + (cdf_hi - cdf_lo) * suffix_excl[i - 1];
    cdf_lo = cdf_hi;
    a_lo = a_hi;
  }
  return total;
}

// xorshift64* for the MC estimator
inline uint64_t xorshift(uint64_t& s) {
  s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
  return s * 0x2545F4914F6CDD1DULL;
}
inline double unif(uint64_t& s) {
  return (xorshift(s) >> 11) * (1.0 / 9007199254740992.0);
}
inline double gauss(uint64_t& s) {
  double u1 = std::max(unif(s), 1e-300), u2 = unif(s);
  return std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * M_PI * u2);
}


}  // namespace

extern "C" double lt_hypervolume(const double*, int, int, const double*);

namespace {
double hv_of(const std::vector<double>& flat, int n, int d,
             const double* ref) {
  return lt_hypervolume(flat.data(), n, d, ref);
}
}  // namespace

extern "C" {

void lt_ehvi2d_batch(const double* mu, const double* sigma, int n_cand,
                     const double* front, int k, const double* ref,
                     double* out) {
  // negate for maximization -> minimization
  std::vector<std::pair<double, double>> f(k);
  for (int i = 0; i < k; ++i) f[i] = {-front[2 * i], -front[2 * i + 1]};
  std::sort(f.begin(), f.end());
  std::vector<double> a(k), b(k);
  for (int i = 0; i < k; ++i) { a[i] = f[i].first; b[i] = f[i].second; }
  const double r1 = -ref[0], r2 = -ref[1];
  for (int c = 0; c < n_cand; ++c) {
    out[c] = ehvi2d_min(-mu[2 * c], -mu[2 * c + 1], sigma[2 * c],
                        sigma[2 * c + 1], a, b, r1, r2);
  }
}

double lt_ehvi_mc(const double* mu, const double* sigma, int d,
                  const double* front, int k, const double* ref,
                  int n_samples, unsigned long long seed) {
  std::vector<double> base(front, front + k * d);
  const double hv0 = hv_of(base, k, d, ref);
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
  std::vector<double> aug(base);
  aug.resize((k + 1) * d);
  double acc = 0.0;
  for (int it = 0; it < n_samples; ++it) {
    for (int j = 0; j < d; ++j)
      aug[k * d + j] = mu[j] + sigma[j] * gauss(s);
    const double hv1 = hv_of(aug, k + 1, d, ref);
    acc += std::max(hv1 - hv0, 0.0);
  }
  return acc / n_samples;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact 3-D EHVI (cell-grid scheme; host cross-check of the device box
// decomposition in limbo_tpu_torch/ops/ehvi.py — reference capability:
// src/ehvi/ehvi_sliceupdate.cc).  Maximization ABI, minimization internals.
// ---------------------------------------------------------------------------

namespace {

// E[(u - max(y, l))^+], y ~ N(mu, s); l may be -inf.
inline double psi_interval(double l, double u, double mu, double s) {
  const double zu = (u - mu) / s;
  if (std::isinf(l)) return s * pdf(zu) + (u - mu) * cdf(zu);
  const double zl = (l - mu) / s;
  return (u - l) * cdf(zl) + (u - mu) * (cdf(zu) - cdf(zl))
         + s * (pdf(zu) - pdf(zl));
}

}  // namespace

extern "C" {

void lt_ehvi3d_batch(const double* mu, const double* sigma, int n_cand,
                     const double* front, int k, const double* ref,
                     double* out) {
  const double inf = std::numeric_limits<double>::infinity();
  // negate to minimization and clip into the ref box
  const double r1 = -ref[0], r2 = -ref[1], r3 = -ref[2];
  std::vector<double> fx(k), fy(k), fz(k);
  for (int i = 0; i < k; ++i) {
    fx[i] = std::min(-front[3 * i + 0], r1);
    fy[i] = std::min(-front[3 * i + 1], r2);
    fz[i] = std::min(-front[3 * i + 2], r3);
  }
  std::vector<double> ex(k + 2), ey(k + 2);
  {
    std::vector<double> xs(fx), ys(fy);
    std::sort(xs.begin(), xs.end());
    std::sort(ys.begin(), ys.end());
    ex[0] = -inf; ey[0] = -inf;
    for (int i = 0; i < k; ++i) { ex[i + 1] = xs[i]; ey[i + 1] = ys[i]; }
    ex[k + 1] = r1; ey[k + 1] = r2;
  }
  // z cutoff per cell: zeta_ij = min{ fz : fx <= ex[i], fy <= ey[j] }
  std::vector<double> zhi((k + 1) * (k + 1));
  for (int i = 0; i <= k; ++i) {
    for (int j = 0; j <= k; ++j) {
      double zeta = inf;
      for (int p = 0; p < k; ++p)
        if (fx[p] <= ex[i] && fy[p] <= ey[j]) zeta = std::min(zeta, fz[p]);
      zhi[i * (k + 1) + j] = std::min(zeta, r3);
    }
  }
  for (int c = 0; c < n_cand; ++c) {
    const double m1 = -mu[3 * c], m2 = -mu[3 * c + 1], m3 = -mu[3 * c + 2];
    const double s1 = std::max(sigma[3 * c], 1e-12);
    const double s2 = std::max(sigma[3 * c + 1], 1e-12);
    const double s3 = std::max(sigma[3 * c + 2], 1e-12);
    // precompute per-axis interval factors
    std::vector<double> px(k + 1), py(k + 1);
    for (int i = 0; i <= k; ++i)
      px[i] = psi_interval(ex[i], ex[i + 1], m1, s1);
    for (int j = 0; j <= k; ++j)
      py[j] = psi_interval(ey[j], ey[j + 1], m2, s2);
    double total = 0.0;
    for (int i = 0; i <= k; ++i) {
      if (px[i] <= 0.0) continue;
      for (int j = 0; j <= k; ++j) {
        const double pz = psi_interval(-inf, zhi[i * (k + 1) + j], m3, s3);
        total += px[i] * py[j] * std::max(pz, 0.0);
      }
    }
    out[c] = total;
  }
}

}  // extern "C"
