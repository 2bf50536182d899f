// Native harness runtime for tpufdtd (C++17, ctypes ABI).
//
// Plays the role of the reference's C++ host harness (main.cpp): input
// generation, error scans over multi-hundred-MB fields, rep statistics and
// CSV output. The device compute path stays in XLA/Pallas; this library keeps
// the host-side hot loops (3*volp-element comparison scans, main.cpp:577-592)
// native instead of NumPy.
//
// Build: make -C tpufdtd/native   (produces libfdtd_harness.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>

extern "C" {

// Error scan between a test field and a reference field (both f64,
// flattened). out[0..4] = max_abs, max_rel (|ref|>1e-10), rel_l2,
// nan_count, inf_count. Mirrors the reference comparison loop semantics
// (main.cpp:577-592) including skipping NaN/Inf test elements.
void tf_error_scan_f64(const double* test, const double* ref, int64_t n,
                       double* out) {
  double max_abs = 0.0, max_rel = 0.0, l2_diff = 0.0, l2_ref = 0.0;
  int64_t nan_count = 0, inf_count = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double t = test[i];
    if (std::isnan(t)) { ++nan_count; continue; }
    if (std::isinf(t)) { ++inf_count; continue; }
    const double r = ref[i];
    const double diff = std::fabs(t - r);
    const double ar = std::fabs(r);
    if (diff > max_abs) max_abs = diff;
    if (ar > 1e-10) {
      const double rel = diff / ar;
      if (rel > max_rel) max_rel = rel;
    }
    l2_diff += diff * diff;
    l2_ref += r * r;
  }
  out[0] = max_abs;
  out[1] = max_rel;
  out[2] = std::sqrt(l2_diff / (l2_ref + 1e-30));
  out[3] = static_cast<double>(nan_count);
  out[4] = static_cast<double>(inf_count);
}

// Field invariant scan (f32): out[0] = max |u| over finite elements,
// out[1] = NaN count, out[2] = Inf count (main.cpp:477-486).
void tf_field_scan_f32(const float* u, int64_t n, double* out) {
  double max_abs = 0.0;
  int64_t nan_count = 0, inf_count = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float v = u[i];
    if (std::isnan(v)) { ++nan_count; continue; }
    if (std::isinf(v)) { ++inf_count; continue; }
    const double a = std::fabs(static_cast<double>(v));
    if (a > max_abs) max_abs = a;
  }
  out[0] = max_abs;
  out[1] = static_cast<double>(nan_count);
  out[2] = static_cast<double>(inf_count);
}

// Ricker wavelet table [nt, nsrc], f32 arithmetic identical to the harness
// generator (main.cpp:292-298).
void tf_ricker(float* dst, int64_t nt, int64_t nsrc, float dt, float f0) {
  for (int64_t t = 0; t < nt; ++t) {
    const float tshift = static_cast<float>(t) * dt - 1.0f / f0;
    const float a = static_cast<float>(M_PI) * static_cast<float>(M_PI) *
                    f0 * f0 * tshift * tshift;
    const float val = (1.0f - 2.0f * a) * std::exp(-a);
    for (int64_t s = 0; s < nsrc; ++s) dst[t * nsrc + s] = val;
  }
}

// Mean / population stddev over n doubles (main.cpp:93-111).
void tf_stats(const double* vals, int64_t n, double* mean, double* stddev) {
  if (n <= 0) { *mean = 0.0; *stddev = 0.0; return; }
  double m = 0.0;
  for (int64_t i = 0; i < n; ++i) m += vals[i];
  m /= static_cast<double>(n);
  double var = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double d = vals[i] - m;
    var += d * d;
  }
  *mean = m;
  *stddev = (n > 1) ? std::sqrt(var / static_cast<double>(n)) : 0.0;
}

// Append `row` to `path`, writing `header` first if the file is new.
// Returns 0 on success.
int tf_csv_append(const char* path, const char* header, const char* row) {
  std::ifstream probe(path);
  const bool exists = probe.good();
  probe.close();
  std::ofstream f(path, std::ios::app);
  if (!f.good()) return 1;
  if (!exists) f << header << "\n";
  f << row << "\n";
  return f.good() ? 0 : 1;
}

}  // extern "C"
