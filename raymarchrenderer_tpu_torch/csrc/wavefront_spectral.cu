// Gen-3 spectral transport, wavefront mode, for Hopper (sm_90a).
//
// Replaces the TPU kernel `render_fused_spectral` in wavefront mode
// (raymarchrenderer_tpu/kernels/march.py:757-767, the pl.pallas_call at
// :782 whose body loops render/spectral_integrator.py `trace_spectral`
// over the samples).  Its plain PyTorch version is
// raymarchrenderer_tpu_torch/kernels/march.py `wavefront_spectral_plain`,
// and the wrapper `render_fused_spectral(mode="wavefront")`.
//
// What a pixel computes is the JAX body's: for each sample the jittered
// primary ray, then `trace_spectral`'s strict bounce loop (the per-step
// march of march_ray.cuh, the band filter of the hit's material row or of
// the 390-830 nm sky band on a miss, from one draw u, then the normal and
// the hemisphere bounce from draws 2 and 3), ending on an emitter hit, an
// absorption or a miss, and the splat `wavelength_to_rgb(wl) * power`
// summed over the samples.  A path that has ended changes nothing in the
// plain version's later (masked) bounces, so the lane stops there.
//
// Bound on the H100: the interpreted map evaluations (FP32 issue,
// divergent), as for the spectral megakernel; a launch reads a few
// hundred bytes of scene and writes 12 bytes per pixel.  What held it
// back was the schedule, as in the RGB wavefront kernel before its
// redesign: one thread per pixel ran three nested loops (samples,
// bounces, march steps), so under SIMT a lane that left an inner loop
// waited for the warp's longest lane at every level; its paths also end
// on absorptions, so the chains of neighbouring pixels differ more than
// on the RGB side.  At the main launch (1024^2, 8 samples, 16 bounces)
// the nested loops kept 0.23 of the lanes' march steps busy and took 36.3
// ms against a bound of 0.43 ms (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
//
// Design: wavefront_paths.cu's lane machine, without NEE, materials or
// dispersion.  Each lane flattens its pixel's loops into one: a pass is up
// to `kWaveUnrollSpectral` march steps of the lane's bounce segment, then
// the events of every lane whose march ended (the band filter, the
// bounce, the end of a path and the start of the next sample's), until
// the lane marches again.  Lanes at different samples and bounces share
// the march steps of one pass.  The grid is persistent: a lane whose
// pixel is done takes the next from the pixel queue of scene_map.cuh.
// The launch bound is `kMinBlocksWavefrontSpectral`; it and
// `kWaveUnrollSpectral` were read by `chip_smoke.py --sweep-const`
// (PERF.md).  The schedule moves work, never an op: each pixel's chain
// runs in one thread in the JAX body's order (--fmad=false), its samples
// summed in order, and every output pixel has one writer, so the output
// is the same bytes as one thread looping over the samples.

#include <cuda_runtime.h>
#include <stdint.h>

#include "march_ray.cuh"
#include "spectral.cuh"

using namespace rmr;

namespace {

// march steps per pass, and the launch bound: at least this many blocks of
// kBlockThreads resident per SM, which caps a thread's registers at 64
// (PERF.md: 16 steps at bound 8 beat 8, 24, 32 and 64 steps at bounds 4,
// 6, 8, 12 and 16)
constexpr int kWaveUnrollSpectral = 16;
constexpr int kMinBlocksWavefrontSpectral = 8;

// lane states: a bounce segment in flight, a path that ended without a
// bounce (max_bounces 0), or no pixel
constexpr int kBounce = 0;
constexpr int kEnd = 1;
constexpr int kIdle = 2;

struct Ctx {
  SpecArgs a;
  SceneRef s;
  MarchParams mp;
  Camera cam;
};

struct Lane {
  MarchState m;  // the bounce segment in flight: its o and d are the ray's
  int state;
  // the pixel: its coordinates, its sum, the sample k
  uint32_t px, py;
  size_t pix;
  V3 acc;
  int k;
  // the path: its bounce, wavelength and power
  int b;
  float wl, power;
};

__device__ __forceinline__ void begin_bounce(const Ctx& c, Lane& L, V3 o, V3 d) {
  march_begin(L.m, c.mp, o, d, 1.0f, c.a.max_dist, true);
  L.state = kBounce;
}

// sample L.k's path: its primary ray, then its first bounce
__device__ void start_path(const Ctx& c, Lane& L) {
  const SpecArgs& a = c.a;
  const uint32_t sample = a.sample0 + (uint32_t)L.k;
  L.wl = 0.0f;
  L.power = 1.0f;
  L.b = 0;
  const V3 d = primary_ray(c.cam, a.seed, L.px, L.py, sample, a.width, a.height);
  if (a.max_bounces > 0) {
    begin_bounce(c, L, c.cam.eye, d);
  } else {
    // no march: the state the pass reads says it is over
    L.state = kEnd;
    L.m.done = true;
    L.m.step = 0;
  }
}

// the pixel's mean; the lane is free
__device__ __forceinline__ void finish_pixel(const Ctx& c, Lane& L, float* __restrict__ out) {
  float* o = out + 3 * L.pix;
  o[0] = L.acc.x * c.a.inv_n;
  o[1] = L.acc.y * c.a.inv_n;
  o[2] = L.acc.z * c.a.inv_n;
  L.state = kIdle;
}

// the pixel (lx, ly) of the patch: its first path
__device__ void start_pixel(const Ctx& c, Lane& L, float* __restrict__ out, int lx, int ly) {
  L.px = (uint32_t)(c.a.ox + lx);
  L.py = (uint32_t)(c.a.oy + ly);
  L.pix = (size_t)ly * c.a.pw + lx;
  L.acc = splat(0.0f);
  L.k = 0;
  if (c.a.n_samples > 0) {
    start_path(c, L);
  } else {
    finish_pixel(c, L, out);
  }
}

// The path's end: its splat joins the pixel's sum; then the next sample's
// path, or the pixel's mean.
__device__ void end_path(const Ctx& c, Lane& L, float* __restrict__ out) {
  L.acc = add(L.acc, scale(wavelength_to_rgb(L.wl), L.power));
  L.k += 1;
  if (L.k < c.a.n_samples) {
    start_path(c, L);
  } else {
    finish_pixel(c, L, out);
  }
}

// The event of a lane whose march has ended (or whose path ended without
// a bounce): trace_spectral's loop body after the march.
template <bool kExact>
__device__ void event(const Ctx& c, Lane& L, float* __restrict__ out) {
  if (L.state == kEnd) {
    end_path(c, L, out);
    return;
  }
  const SpecArgs& a = c.a;
  int mid;
  bool hit;
  const float t = march_result(L.m, mid, hit);
  Rng rng = rng_make(a.seed, L.px, L.py, a.sample0 + (uint32_t)L.k, (uint32_t)L.b);
  const float u = rng_next(rng);
  if (!hit) {
    apply_band(L.wl, L.power, u, 390.0f, 830.0f, a.sky_power);  // the sky emits
    end_path(c, L, out);
    return;
  }
  const V3 hitp = add(L.m.o, scale(L.m.d, t));
  // the band table tail: ints [n_mats, kind * n_mats], floats
  // [min_wave * n_mats, max_wave * n_mats, power * n_mats]
  const int* tail = c.s.prog() + c.s.prog()[1];
  const int n_mats = tail[0];
  const float* band = c.s.f() + c.s.prog()[2];
  const int row = mid < 0 ? 0 : (mid > n_mats - 1 ? n_mats - 1 : mid);
  const bool absorbed =
      apply_band(L.wl, L.power, u, band[row], band[n_mats + row], band[2 * n_mats + row]);
  if (tail[1 + row] == 1 || absorbed) {
    end_path(c, L, out);
    return;
  }
  const V3 normal = get_normal<kExact>(c.s, a.max_dist, a.normal_eps, a.normal_taps, hitp);
  const float u1 = rng_next(rng);
  const float u2 = rng_next(rng);
  const V3 d = uniform_sphere_or_hemisphere(u1, u2, normal);
  const V3 o = add(hitp, scale(normal, a.surface_offset));
  L.b += 1;
  if (L.b < a.max_bounces) {
    begin_bounce(c, L, o, d);
  } else {
    end_path(c, L, out);
  }
}

// kExact: the exact normal (normal_taps = 0)
template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksWavefrontSpectral)
    wavefront_spectral_kernel(SpecArgs a, SceneDims dims, const float* __restrict__ corners,
                              const float* __restrict__ fdata, const int* __restrict__ prog,
                              float* __restrict__ out, int* __restrict__ queue) {
  // the scene and its band table, once per block in shared memory
  const SceneRef scene = stage_scene(prog, fdata, dims);
  Ctx c;
  c.a = a;
  c.s = scene;
  c.mp.max_steps = a.max_steps;
  c.mp.relax = a.relax;
  c.mp.max_dist = a.max_dist;
  c.mp.hit_eps = a.hit_eps;
  c.mp.step_multiply = a.step_multiply;
  c.mp.relax_omega = a.relax_omega;
  c.cam = load_camera(corners);
  const int n_slots = queue_len(a.pw, a.ph);
  Lane L;
  L.state = kIdle;
  // start the lane on queue slot q's pixel (none outside the patch)
  auto take = [&](int q) {
    int lx, ly;
    if (queue_pixel(a.pw, a.ph, q, lx, ly)) start_pixel(c, L, out, lx, ly);
  };
  // one pass: the march steps, then the events until the lane marches again
  auto pass = [&]() {
    for (int u = 0; u < kWaveUnrollSpectral; ++u) {
      if (L.state != kIdle && march_live(L.m, c.mp)) march_advance(c.s, c.mp, L.m);
    }
    while (L.state != kIdle && !march_live(L.m, c.mp)) event<kExact>(c, L, out);
  };
  bool drained = false;
  for (;;) {
    const bool ask = L.state == kIdle && !drained;
    const int q = take_slot(queue, ask);
    if (ask) {
      if (q >= n_slots) {
        drained = true;
      } else {
        take(q);
      }
    }
    if (__all_sync(0xffffffffu, drained && L.state == kIdle)) break;
    if (L.state != kIdle) pass();
  }
}

}  // namespace

// Plain C entry point for ctypes.  `args` is a host pointer; the buffers
// are device pointers on CUDA device `device`; `out` is (ph, pw, 3)
// float32, the mean (times inv_n) over `n_samples` samples from
// `sample0`.  Reads no schedule knob of `args`.  `dims` (a host pointer)
// holds the sizes of the scene's buffers (scene_map.cuh SceneDims).
// `queue` is one int32 on the device, zero before the launch (the pixel
// queue's counter).  Returns the first CUDA error (0 on success).
extern "C" int rmr_wavefront_spectral(const SpecArgs* args, const SceneDims* dims,
                                      const float* corners, const float* fdata, const int* prog,
                                      float* out, int* queue, cudaStream_t stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_slots = queue_len(args->pw, args->ph);
  int grid = 0;
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  auto kernel = exact ? wavefront_spectral_kernel<true> : wavefront_spectral_kernel<false>;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) err = persistent_grid(kernel, bytes, device, n_slots, grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, corners, fdata, prog, out, queue);
  return (int)cudaGetLastError();
}
