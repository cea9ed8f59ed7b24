// Shared device helpers for the pair kernels: the reference's A&S 7.1.26
// erfc polynomial (fix_conp.cpp:53-60, ops/erfc.py), its ERFC_MAX clamp, and
// the orthogonal-box minimum image.  Every formula is the one the plain
// PyTorch versions evaluate, so kernel and plain version differ by float32
// rounding only.
#pragma once

#include <cuda_runtime.h>

namespace conp2 {

constexpr float EWALD_F = 1.12837917f;   // 2/sqrt(pi)
constexpr float EWALD_P = 0.3275911f;
constexpr float A1 = 0.254829592f;
constexpr float A2 = -0.284496736f;
constexpr float A3 = 1.421413741f;
constexpr float A4 = -1.453152027f;
constexpr float A5 = 1.061405429f;
constexpr float ERFC_MAX_SQ = 5.8f * 5.8f;

// the polynomial factor of erfc(a) = poly(t) * exp(-a^2), t = 1/(1 + p a)
__device__ __forceinline__ float as_poly(float a) {
  const float t = 1.0f / (1.0f + EWALD_P * a);
  return t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5))));
}

// erfc(sqrt(u))/sqrt(u), clamped to 0 for u >= ERFC_MAX^2, given
// expm2 = exp(-u) (the Gaussian chains already have it).  One rsqrt
// serves sqrt(u) and 1/sqrt(u).
__device__ __forceinline__ float erfcr_clamped(float u, float expm2) {
  const float safe = fmaxf(u, 1e-30f);
  const float rs = rsqrtf(safe);
  const float val = as_poly(safe * rs) * expm2 * rs;
  return u < ERFC_MAX_SQ ? val : 0.0f;
}

// minimum image on one axis: d - L * round(d / L), round half to even
__device__ __forceinline__ float min_image(float d, float len, float inv_len,
                                           int periodic) {
  return periodic ? d - len * rintf(d * inv_len) : d;
}

}  // namespace conp2
