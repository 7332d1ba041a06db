// Hypervolume indicator + non-dominated filtering (native host component).
//
// Capability parity with the reference's vendored Zitzler code
// (reference: src/hv/hypervol.c — FilterNondominatedSet,
// CalculateHypervolume), reimplemented from scratch with the classic
// recursive dimension-sweep algorithm.  Convention: MAXIMIZATION relative to
// a reference point `ref` (every counted point must dominate ref).
//
// Exposed C ABI (ctypes):
//   int    lt_filter_nondominated(double* pts, int n, int d, int* keep);
//   double lt_hypervolume(const double* pts, int n, int d, const double* ref);

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

inline bool dominates(const double* a, const double* b, int d) {
  bool strict = false;
  for (int k = 0; k < d; ++k) {
    if (a[k] < b[k]) return false;
    if (a[k] > b[k]) strict = true;
  }
  return strict;
}

// recursive dimension-sweep: hv of pts (maximization, ref at origin after
// shifting).  pts are rows of length d; modifies its local copy.
double hv_recursive(std::vector<const double*>& pts, int d,
                    const double* ref) {
  const int n = static_cast<int>(pts.size());
  if (n == 0) return 0.0;
  if (d == 1) {
    double best = ref[0];
    for (auto p : pts) best = std::max(best, p[0]);
    return best - ref[0];
  }
  if (d == 2) {
    // sort by obj0 descending, sweep the staircase
    std::vector<const double*> s(pts);
    std::sort(s.begin(), s.end(),
              [](const double* a, const double* b) { return a[0] > b[0]; });
    double vol = 0.0, h = ref[1];
    for (auto p : s) {
      if (p[1] > h) {
        vol += (p[0] - ref[0]) * (p[1] - h);
        h = p[1];
      }
    }
    return vol;
  }
  // general case: sweep the last objective.  Sort descending in obj d-1;
  // between consecutive levels the (d-1)-dim hv of the prefix set applies.
  std::vector<const double*> s(pts);
  std::sort(s.begin(), s.end(), [d](const double* a, const double* b) {
    return a[d - 1] > b[d - 1];
  });
  double vol = 0.0;
  std::vector<const double*> prefix;
  for (int i = 0; i < n; ++i) {
    prefix.push_back(s[i]);
    const double hi = s[i][d - 1];
    const double lo = (i + 1 < n) ? s[i + 1][d - 1] : ref[d - 1];
    if (hi > lo) {
      double slab = hv_recursive(prefix, d - 1, ref);
      vol += slab * (hi - lo);
    }
  }
  return vol;
}

}  // namespace

extern "C" {

int lt_filter_nondominated(const double* pts, int n, int d, int* keep) {
  int cnt = 0;
  for (int i = 0; i < n; ++i) {
    bool dom = false;
    for (int j = 0; j < n && !dom; ++j) {
      if (j != i && dominates(pts + j * d, pts + i * d, d)) dom = true;
    }
    keep[i] = dom ? 0 : 1;
    cnt += keep[i];
  }
  return cnt;
}

double lt_hypervolume(const double* pts, int n, int d, const double* ref) {
  // drop points that do not strictly dominate ref (zero contribution)
  std::vector<const double*> rows;
  rows.reserve(n);
  for (int i = 0; i < n; ++i) {
    const double* p = pts + i * d;
    bool above = true;
    for (int k = 0; k < d; ++k)
      if (p[k] <= ref[k]) { above = false; break; }
    if (above) rows.push_back(p);
  }
  return hv_recursive(rows, d, ref);
}

}  // extern "C"
