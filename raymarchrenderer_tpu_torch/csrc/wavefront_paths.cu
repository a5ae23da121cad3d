// RGB path tracer, wavefront mode, for Hopper (sm_90a).
//
// Replaces the TPU kernel `render_fused_patch` in wavefront mode
// (raymarchrenderer_tpu/kernels/march.py:395, the pl.pallas_call whose
// `_tile_kernel` body loops render/integrator.py `trace_rgb` over the
// samples: `:238-265`, and with the deferred sky `:184-236`).  Its plain
// PyTorch version is raymarchrenderer_tpu_torch/kernels/march.py
// `wavefront_paths_plain` (render/integrator.py `render_patch` sample by
// sample), and the wrapper `render_fused_patch(mode="wavefront")`.
//
// What a pixel computes is the JAX body's: for each sample the jittered
// primary ray, then `trace_rgb`'s bounce loop: the strict per-step march of
// march_ray.cuh (the plain version's `march`, material from the hit step),
// the normal, the hit's material through the material interpreter of
// paths_shade.cuh from its rng_base, next-event estimation (one shadow
// march per light toward a jittered point, capped at the light's
// distance, `light_ray`, summed over the lights before it joins the
// path's NEE radiance), the roulette, and on a miss the sky: the
// constant, the SH sky (`sh_eval`, 48 coefficients of the staged tail)
// or, for an env image, the miss event banked for the composite.  Under
// dispersion a sample is three one-channel paths sharing its primary
// ray, with shade streams s * 4 + ci + 1, summed before they join the
// pixel's sum.  A path that has ended changes nothing in the plain
// version's later (masked) bounces, so the lane stops there.
//
// Deferred sky (`sky_kind` kSkyDefer, an argument beside PathArgs, as for
// rmr_mega_paths): the launch traces path slots
// k < n_samples (the wrapper's n_valid) of the (sample, channel) path
// counter from `sample0`, writes the raw sum of their colours without the
// sky to `out`, and banks each slot's miss throughput and raw direction
// into six (K, ph, pw) float32 planes at slot k; the wrapper zero-fills
// them, so a slot that never missed, or is not traced, keeps thr = 0.
// The composite (`composite_dir`) evaluates `Scene.sky` on the directions.
//
// Bound on the H100: the interpreted map evaluations (FP32 issue,
// divergent), as for the megakernel; a launch reads a few hundred bytes
// of scene and writes 12 bytes per pixel (plus 24 per slot and pixel with
// the deferred sky).  What held it back was the schedule: one thread ran
// four nested loops (samples, bounces, march steps, and the NEE shadow
// marches), so under SIMT a lane that left an inner loop waited for the
// warp's longest lane at every level, and a path that had ended waited
// for the warp's longest path of that sample.
//
// Design: a lane machine.  Each lane flattens its pixel's nested loops
// into one: a pass is up to `kWaveUnroll` march steps of the lane's
// current segment, a bounce ray or a shadow ray, both marched by the same
// step code, then the events of every lane whose segment ended (shade
// with NEE set-up and roulette, the next light, a miss and its sky, the
// end of a path and the start of the next sample's), until the lane
// marches again.  Lanes at different samples, bounces and lights share
// the march steps of one pass.  The grid is persistent: a lane whose
// pixel is done takes the next from the pixel queue of scene_map.cuh
// (its chains vary too much for one lane per pixel: PERF.md).  The
// launch bound is `kMinBlocksWavefront` (scene_map.cuh), read by
// `chip_smoke.py --sweep-const`.  The schedule moves work, never an op: each pixel's
// chain runs in one thread in the JAX body's order (--fmad=false), the
// per-sample and per-light sums keep their order, and every output slot
// has one writer, so the output is the same bytes as one thread looping
// over the samples.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paths_shade.cuh"

using namespace rmr;

namespace {

// march steps per pass (PERF.md: 32 beat 1, 4, 8, 16, 64 and 128)
constexpr int kWaveUnroll = 32;

// lane states: the segment in flight, a path that ended without a bounce
// (max_bounces 0), or no pixel
constexpr int kBounce = 0;
constexpr int kShadow = 1;
constexpr int kEnd = 2;
constexpr int kIdle = 3;

struct Ctx {
  PathArgs a;
  SceneRef s;
  MarchParams mp;
  int sky_kind;  // the light table and the sky in the scene's tail
  Camera cam;
};

// The deferred sky's banks of one launch: (K, ph, pw) planes.
struct MissBanks {
  float* plane[6];  // thr_r, thr_g, thr_b, dir_x, dir_y, dir_z
  size_t stride;    // ph * pw
};

struct Lane {
  MarchState m;  // the bounce or shadow segment in flight
  int state;
  // the pixel: its coordinates, its sum, the sample (path slot) k, the
  // channel ci of a dispersed sample and that sample's channel sum
  uint32_t px, py;
  size_t pix;
  V3 acc, col;
  int k;
  uint32_t ci;
  // the path: origin and direction of its next bounce, throughput, NEE
  // radiance, bounce, shade stream, miss event
  V3 o, d, color, extra, miss_thr, miss_dir;
  float inside;
  int b;
  uint32_t sid;
  // NEE at the last hit: the point, the normal, throughput x material
  // colour, the stream, the light and the sum over the lights so far;
  // whether the path goes on after it
  V3 nee_p, nee_n, nee_thr, total;
  Rng nrng;
  int li;
  bool cont;
};

__device__ __forceinline__ V3 one_hot(uint32_t ci) {
  return mk(ci == 0u ? 1.0f : 0.0f, ci == 1u ? 1.0f : 0.0f, ci == 2u ? 1.0f : 0.0f);
}

__device__ __forceinline__ V3 path_channels(const Ctx& c, const Lane& L) {
  return c.a.dispersion ? one_hot(L.ci) : splat(1.0f);
}

__device__ __forceinline__ void begin_bounce(const Ctx& c, Lane& L) {
  march_begin(L.m, c.mp, L.o, L.d, 1.0f - 2.0f * L.inside, c.a.max_dist, true);
  L.state = kBounce;
}

// the shadow segment toward a jittered point of light L.li
__device__ __forceinline__ void begin_light(const Ctx& c, Lane& L) {
  V3 ldir;
  const float dist_l = light_ray(light_table(c.s), c.a.n_lights, L.li, L.nrng, L.nee_p, ldir);
  const V3 o_sh = add(L.nee_p, scale(L.nee_n, c.a.surface_offset));
  march_begin(L.m, c.mp, o_sh, ldir, 1.0f, dist_l, true);
  L.state = kShadow;
}

// path slot L.k (channel L.ci of a dispersed sample without the deferred
// sky): its primary ray, then its first bounce
__device__ void start_path(const Ctx& c, Lane& L) {
  const PathArgs& a = c.a;
  const uint32_t s = a.sample0 + (uint32_t)L.k;
  uint32_t samp = s;
  if (c.sky_kind == kSkyDefer) {
    samp = a.dispersion ? s / 3u : s;
    L.ci = s % 3u;
    L.sid = a.dispersion ? samp * 4u + L.ci + 1u : s;
  } else {
    L.sid = a.dispersion ? s * 4u + L.ci + 1u : s;
  }
  L.o = c.cam.eye;
  L.d = primary_ray(c.cam, a.seed, L.px, L.py, samp, a.width, a.height);
  L.color = path_channels(c, L);
  L.extra = splat(0.0f);
  L.miss_thr = splat(0.0f);
  L.miss_dir = splat(0.0f);
  L.inside = 0.0f;
  L.b = 0;
  if (a.max_bounces > 0) {
    begin_bounce(c, L);
  } else {
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
  L.col = splat(0.0f);
  L.k = 0;
  L.ci = 0u;
  if (c.a.n_samples > 0) {
    start_path(c, L);
  } else {
    finish_pixel(c, L, out);
  }
}

// The path's end: its colour joins the pixel's sum (through the sample's
// channel sum under dispersion), its miss event goes to its bank slot;
// then the next path, or the pixel's mean.
__device__ void end_path(const Ctx& c, Lane& L, float* __restrict__ out, const MissBanks& banks) {
  const PathArgs& a = c.a;
  const V3 pc = add(L.color, L.extra);
  if (c.sky_kind == kSkyDefer) {
    const size_t slot = (size_t)L.k * banks.stride + L.pix;
    banks.plane[0][slot] = L.miss_thr.x;
    banks.plane[1][slot] = L.miss_thr.y;
    banks.plane[2][slot] = L.miss_thr.z;
    banks.plane[3][slot] = L.miss_dir.x;
    banks.plane[4][slot] = L.miss_dir.y;
    banks.plane[5][slot] = L.miss_dir.z;
    L.acc = add(L.acc, pc);
    L.k += 1;
  } else if (a.dispersion) {
    L.col = add(L.col, pc);
    L.ci += 1u;
    if (L.ci == 3u) {
      L.acc = add(L.acc, L.col);
      L.col = splat(0.0f);
      L.ci = 0u;
      L.k += 1;
    }
  } else {
    L.acc = add(L.acc, pc);
    L.k += 1;
  }
  if (L.k < a.n_samples) {
    start_path(c, L);
  } else {
    finish_pixel(c, L, out);
  }
}

// after a hit and its NEE: the next bounce, or the path's end
__device__ __forceinline__ void after_hit(const Ctx& c, Lane& L, float* __restrict__ out,
                                          const MissBanks& banks) {
  if (L.cont) {
    L.b += 1;
    if (L.b < c.a.max_bounces) {
      begin_bounce(c, L);
      return;
    }
  }
  end_path(c, L, out, banks);
}

// A bounce ray's hit: the normal, the material, NEE's set-up, the
// roulette and the next ray (trace_rgb's loop body).
template <bool kExact>
__device__ void shade(const Ctx& c, Lane& L, float t, int mid, float* __restrict__ out,
                      const MissBanks& banks) {
  const PathArgs& a = c.a;
  ShadeIn in;
  in.origin = L.o;
  in.dir = L.d;
  in.t = t;
  in.inside = L.inside;
  in.hit = add(L.o, scale(L.d, t));
  in.normal = get_normal<kExact>(c.s, a.max_dist, a.normal_eps, a.normal_taps, in.hit);
  in.channels = path_channels(c, L);
  Rng rng = rng_make(a.seed, L.px, L.py, L.sid, (uint32_t)L.b);
  const ShadeOut so = eval_material(c.s, mid, in, rng);
  L.color = mul(L.color, so.color);
  const bool new_inside = so.inside.x > 0.5f;
  L.inside = new_inside ? 1.0f : 0.0f;
  bool active = !is_zero(so.dir);
  const bool nee = a.nee && active;
  if (nee) {
    // every light's shadow ray sees the throughput before the roulette
    L.nee_p = in.hit;
    L.nee_n = in.normal;
    L.nee_thr = L.color;
    L.nrng = rng_fork(rng, 7u);
    L.total = splat(0.0f);
    L.li = 0;
  }
  if (a.rr_start_bounce >= 0) {
    const float p = fminf(fmaxf(fmaxf(L.color.x, fmaxf(L.color.y, L.color.z)), a.rr_min_prob), 1.0f);
    Rng rr = rng_fork(rng, 13u);
    const float u = rng_next(rr);
    const bool do_rr = active && L.b >= a.rr_start_bounce;
    const bool kill = do_rr && u >= p;
    if (kill) {
      L.color = splat(0.0f);
    } else if (do_rr) {
      L.color = scale(L.color, 1.0f / p);
    }
    active = active && !kill;
  }
  L.cont = active;
  if (active) {
    const float off = new_inside ? -a.inside_offset : a.exit_offset;
    L.o = is_zero(so.hit) ? add(in.hit, scale(in.normal, off)) : so.hit;
    L.d = so.dir;
  }
  if (nee) {
    if (a.n_lights > 0) {
      begin_light(c, L);
      return;
    }
    L.extra = add(L.extra, L.total);
  }
  after_hit(c, L, out, banks);
}

// A finished shadow ray: its light's contribution joins the hit's sum;
// then the next light, or the sum joins the path's NEE radiance.
__device__ void resolve_light(const Ctx& c, Lane& L, float* __restrict__ out,
                              const MissBanks& banks) {
  int smid;
  bool shit;
  const float sd = march_result(L.m, smid, shit);
  const V3 ldir = L.m.d;
  const float dist_l = L.m.tmax;
  const int n = c.a.n_lights;
  const float cos_t = fmaxf(dot(ldir, L.nee_n), 0.0f);
  const float fall = light_table(c.s)[3 * n + L.li] / fmaxf(dist_l * dist_l, 1e-8f);
  const V3 contrib = scale(L.nee_thr, cos_t * fall / kPi);
  L.total = add(L.total, sd >= dist_l ? contrib : splat(0.0f));
  L.li += 1;
  if (L.li < n) {
    begin_light(c, L);
    return;
  }
  L.extra = add(L.extra, L.total);
  after_hit(c, L, out, banks);
}

// The event of a lane whose segment has ended (or whose path ended
// without a bounce).
template <bool kExact>
__device__ void event(const Ctx& c, Lane& L, float* __restrict__ out, const MissBanks& banks) {
  if (L.state == kShadow) {
    resolve_light(c, L, out, banks);
    return;
  }
  if (L.state == kEnd) {
    end_path(c, L, out, banks);
    return;
  }
  int mid;
  bool hit;
  const float t = march_result(L.m, mid, hit);
  if (hit) {
    shade<kExact>(c, L, t, mid, out, banks);
    return;
  }
  if (c.sky_kind == kSkyDefer) {
    // bank the miss event; the composite adds miss_thr * sky(miss_dir)
    L.miss_thr = L.color;
    L.miss_dir = L.d;
    L.color = mul(L.color, splat(0.0f));
  } else if (c.sky_kind == kSkySh) {
    L.color = mul(L.color, sh_eval(sh_coeffs(c.s), L.d));
  } else {
    L.color = mul(L.color, splat(sky_power(c.s)));
  }
  end_path(c, L, out, banks);
}

template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksWavefront) wavefront_paths_kernel(
    PathArgs a, SceneDims dims, int sky_kind, const float* __restrict__ corners,
    const float* __restrict__ fdata, const int* __restrict__ prog, float* __restrict__ out,
    MissBanks banks, int* __restrict__ queue) {
  // the scene, the sky, the light table and the SH coefficients, once per
  // block in shared memory
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
  c.sky_kind = sky_kind;
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
    for (int u = 0; u < kWaveUnroll; ++u) {
      if (L.state != kIdle && march_live(L.m, c.mp)) march_advance(c.s, c.mp, L.m);
    }
    while (L.state != kIdle && !march_live(L.m, c.mp)) event<kExact>(c, L, out, banks);
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
// float32: the mean (times inv_n) over `n_samples` samples from `sample0`
// for a constant or SH sky; for an env image (`sky_kind` kSkyDefer) the
// raw sum over path slots 0 .. n_samples - 1 from path `sample0`, with
// `thr_r` .. `dir_z` each (K >= n_samples, ph, pw) float32, zero-filled by
// the caller.  `dims` (a host pointer) holds the sizes of the scene's
// buffers (scene_map.cuh SceneDims).  `queue` is one int32 on the
// device, zero before the launch (the pixel queue's counter).  Returns the
// first CUDA error (0 on success), and cudaErrorInvalidValue for a scene
// whose tables exceed the block's shared memory or a deferred sky without
// banks.
extern "C" int rmr_wavefront_paths(const PathArgs* args, const SceneDims* dims, int sky_kind,
                                   const float* corners, const float* fdata, const int* prog,
                                   float* out, float* thr_r, float* thr_g, float* thr_b,
                                   float* dir_x, float* dir_y, float* dir_z, int* queue,
                                   cudaStream_t stream, int device) {
  if (args->n_lights < 0) return (int)cudaErrorInvalidValue;
  MissBanks banks;
  float* planes[6] = {thr_r, thr_g, thr_b, dir_x, dir_y, dir_z};
  for (int i = 0; i < 6; ++i) {
    if (sky_kind == kSkyDefer && planes[i] == nullptr) return (int)cudaErrorInvalidValue;
    banks.plane[i] = planes[i];
  }
  banks.stride = (size_t)args->ph * args->pw;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_slots = queue_len(args->pw, args->ph);
  int grid = 0;
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  auto kernel = exact ? wavefront_paths_kernel<true> : wavefront_paths_kernel<false>;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) err = persistent_grid(kernel, bytes, device, n_slots, grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, sky_kind, corners, fdata, prog, out,
                                                 banks, queue);
  return (int)cudaGetLastError();
}
