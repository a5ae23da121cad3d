// Gen-3 spectral transport, wavefront mode, for Hopper (sm_90a).
//
// Replaces the TPU kernel `render_fused_spectral` in wavefront mode
// (raymarchrenderer_tpu/kernels/march.py:757-767, the pl.pallas_call at
// :782 whose body loops render/spectral_integrator.py `trace_spectral`
// over the samples).  Its plain PyTorch version is
// raymarchrenderer_tpu_torch/kernels/march.py `wavefront_spectral_plain`,
// and the wrapper `render_fused_spectral(mode="wavefront")`.
//
// Design.  One thread per pixel of the patch: for each sample the
// jittered primary ray, then `trace_spectral`'s strict bounce loop (the
// per-step march of march_ray.cuh, the normal, the band filter of the
// hit's material row or of the 390-830 nm sky band on a miss, from one
// draw u, then the hemisphere bounce from draws 2 and 3), ending on an
// emitter hit, an absorption or a miss, and the splat
// `wavelength_to_rgb(wl) * power` summed over the samples.  A path that
// has ended changes nothing in the plain version's later (masked)
// bounces, so the thread stops there.
//
// Bound on the H100: the interpreted map evaluations (FP32 issue,
// divergent), as for the spectral megakernel; a launch reads a few
// hundred bytes of scene and writes 12 bytes per pixel.  Without the
// megakernel's in-loop regeneration a warp waits for its slowest path
// every sample; this mode exists for parity and is kept simple.

#include <cuda_runtime.h>
#include <stdint.h>

#include "march_ray.cuh"
#include "spectral.cuh"

using namespace rmr;

namespace {

// kExact: the exact normal (normal_taps = 0)
template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads) wavefront_spectral_kernel(
    SpecArgs a, SceneDims dims, const float* __restrict__ corners,
    const float* __restrict__ fdata, const int* __restrict__ prog, float* __restrict__ out) {
  // the scene and its band table, once per block in shared memory
  const SceneRef s = stage_scene(prog, fdata, dims);
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= a.pw || ly >= a.ph) return;
  MarchParams mp;
  mp.max_steps = a.max_steps;
  mp.relax = a.relax;
  mp.max_dist = a.max_dist;
  mp.hit_eps = a.hit_eps;
  mp.step_multiply = a.step_multiply;
  mp.relax_omega = a.relax_omega;
  // the band table tail: ints [n_mats, kind * n_mats], floats
  // [min_wave * n_mats, max_wave * n_mats, power * n_mats]
  const int* tail = s.prog() + s.prog()[1];
  const int n_mats = tail[0];
  const float* band = s.f() + s.prog()[2];
  const uint32_t px = (uint32_t)(a.ox + lx);
  const uint32_t py = (uint32_t)(a.oy + ly);
  const Camera cam = load_camera(corners);
  V3 acc = splat(0.0f);
  for (int k = 0; k < a.n_samples; ++k) {
    const uint32_t sample = a.sample0 + (uint32_t)k;
    V3 o = cam.eye;
    V3 d = primary_ray(cam, a.seed, px, py, sample, a.width, a.height);
    float wl = 0.0f, power = 1.0f;
    for (int b = 0; b < a.max_bounces; ++b) {
      int mid;
      bool hit;
      const float t = march_ray(s, mp, o, d, 1.0f, a.max_dist, true, mid, hit);
      const V3 hitp = add(o, scale(d, t));
      Rng rng = rng_make(a.seed, px, py, sample, (uint32_t)b);
      const float u = rng_next(rng);
      if (!hit) {
        apply_band(wl, power, u, 390.0f, 830.0f, a.sky_power);  // the sky emits
        break;
      }
      const int row = mid < 0 ? 0 : (mid > n_mats - 1 ? n_mats - 1 : mid);
      const bool absorbed =
          apply_band(wl, power, u, band[row], band[n_mats + row], band[2 * n_mats + row]);
      if (tail[1 + row] == 1 || absorbed) break;
      const V3 normal = get_normal<kExact>(s, a.max_dist, a.normal_eps, a.normal_taps, hitp);
      const float u1 = rng_next(rng);
      const float u2 = rng_next(rng);
      d = uniform_sphere_or_hemisphere(u1, u2, normal);
      o = add(hitp, scale(normal, a.surface_offset));
    }
    acc = add(acc, scale(wavelength_to_rgb(wl), power));
  }
  float* op = out + 3 * ((size_t)ly * a.pw + lx);
  op[0] = acc.x * a.inv_n;
  op[1] = acc.y * a.inv_n;
  op[2] = acc.z * a.inv_n;
}

}  // namespace

// Plain C entry point for ctypes.  `args` is a host pointer; the buffers
// are device pointers on CUDA device `device`; `out` is (ph, pw, 3)
// float32, the mean (times inv_n) over `n_samples` samples from
// `sample0`.  Reads no schedule knob.  `dims` (a host pointer) holds the
// sizes of the scene's buffers (scene_map.cuh SceneDims).  Returns the
// first CUDA error (0 on success).
extern "C" int rmr_wavefront_spectral(const SpecArgs* args, const SceneDims* dims,
                                      const float* corners, const float* fdata, const int* prog,
                                      float* out, cudaStream_t stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(16, kBlockThreads / 16);
  const dim3 grid((args->pw + block.x - 1) / block.x, (args->ph + block.y - 1) / block.y);
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  auto kernel = exact ? wavefront_spectral_kernel<true> : wavefront_spectral_kernel<false>;
  err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, bytes, stream>>>(*args, *dims, corners, fdata, prog, out);
  return (int)cudaGetLastError();
}
