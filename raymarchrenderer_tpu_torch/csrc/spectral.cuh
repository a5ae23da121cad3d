// Shared device code of the spectral kernels (mega_spectral.cu,
// wavefront_spectral.cu): the launch scalars `SpecArgs`, the
// wavelength-to-RGB splat (core/spectral.py) and one band filter
// (render/spectral_integrator.py `_apply_band`), op for op.
#pragma once

#include "scene_map.cuh"

namespace rmr {

// Scalars of one launch; the ctypes structure in kernels/march.py mirrors
// this field for field.
struct SpecArgs {
  int width, height;            // full frame (the raygen divisor)
  int ox, oy, pw, ph;           // patch origin and shape
  uint32_t sample0, seed;
  int n_samples, max_steps, max_bounces;
  int march_unroll, regen_cadence, lazy_miss, relax, normal_taps;
  float max_dist, hit_eps, step_multiply, relax_omega, one_minus_omega;
  float omega0, normal_eps, surface_offset, sky_power, inv_n;
};

// ---- transport pieces -----------------------------------------------------

// wavelengthToColor (core/spectral.py), same where-chain
__device__ V3 wavelength_to_rgb(float wl) {
  float r = (wl >= 380.0f && wl < 440.0f) ? -(wl - 440.0f) / 60.0f : 0.0f;
  if (wl >= 510.0f && wl < 580.0f) r = (wl - 510.0f) / 70.0f;
  if (wl >= 580.0f && wl < 645.0f) r = 1.0f;
  if (wl >= 645.0f && wl <= 780.0f) r = 1.0f;
  float g = (wl >= 440.0f && wl < 490.0f) ? (wl - 440.0f) / 50.0f : 0.0f;
  if (wl >= 490.0f && wl < 510.0f) g = 1.0f;
  if (wl >= 510.0f && wl < 580.0f) g = 1.0f;
  if (wl >= 580.0f && wl < 645.0f) g = -(wl - 645.0f) / 65.0f;
  float b = (wl >= 380.0f && wl < 440.0f) ? 1.0f : 0.0f;
  if (wl >= 440.0f && wl < 490.0f) b = 1.0f;
  if (wl >= 490.0f && wl < 510.0f) b = -(wl - 510.0f) / 20.0f;
  float alpha = (wl > 780.0f || wl < 380.0f) ? 0.0f : 1.0f;
  if (wl > 700.0f && wl <= 780.0f) alpha = (780.0f - wl) / 80.0f;
  if (wl < 420.0f && wl >= 380.0f) alpha = (wl - 380.0f) / 40.0f;
  return mk(r * alpha, g * alpha, b * alpha);
}

// one mat_func_N body (render/spectral_integrator.py _apply_band)
__device__ __forceinline__ bool apply_band(float& wl, float& power, float u, float mn, float mx,
                                           float p) {
  const float r = u * (mx - mn) / 5.0f;
  const float sampled = floorf(r) * 5.0f + mn;
  const bool unset = wl == 0.0f;
  const bool outside = wl < mn || wl > mx;
  if (unset || !outside) power = power * p;
  wl = unset ? sampled : (outside ? 0.0f : wl);
  return !unset && outside;
}

}  // namespace rmr
