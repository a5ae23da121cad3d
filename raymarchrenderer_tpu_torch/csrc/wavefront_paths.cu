// RGB path tracer and recorder, wavefront mode, for Hopper (sm_90a).
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
//
// The wavefront recorder.  The entry `rmr_record_wavefront` replaces the
// TPU kernel `trace_record_fused` in wavefront mode (raymarchrenderer_tpu/
// kernels/record.py:59, the pl.pallas_call at :274, which marches each
// bounce over a tile with a per-tile early-out).  Its plain version is
// kernels/record.py `record_wavefront_plain` and its wrapper
// `trace_record_wavefront`.  It runs the same lane machine under the
// `RecordOut` policy: a lane takes a ray of the given planes (eye,
// direction, pixel, sample) from a ray queue, as march_fused.cu does (ray
// indices in order), and its chain is that ray's bounces with their NEE
// shadow segments, the render's ops without the sky, the path sums and
// the samples.  Each bounce march banks (t, material, hit) at slot b * n +
// i; a hit shades (the normal, the material from the shade stream of the
// ray's sample at bounce b, the throughput, `inside`), sets up NEE and
// runs the roulette; each light's segment banks its visibility (3.4e38
// lit, 0 occluded) at slot (b * L + li) * n + i.  A lane that stops
// banks nothing more: its remaining slots keep the miss values the
// wrapper filled in, which is what the plain version's masked march
// returns for it (a shadow ray of an inactive lane returns its t_max, so
// it banks lit).  A miss would multiply the throughput by the sky, but
// the chain ends there and the roulette never reads it again, so it is
// left out.  The roulette reads only the throughput, so running it before
// the shadow segments (as the render does) gives the same draws.  Bound:
// 36 bytes of ray planes in and 12 per bounce out per ray (plus 4 per
// light and bounce with NEE); the operations (the plain version's
// `work`) bind (PERF.md).  What held the one-thread-per-ray kernel back
// was the render's old schedule: nested loops over the bounces, the march
// steps and the lights, a grid of one block per 128 rays that staged the
// scene once per block, and no minimum of resident blocks.  Its steps a
// pass and its launch bound are the render's: a sweep of the bound over
// 6, 8 and 12 and of the steps over 8, 16 and 32 found none faster at the
// main launch (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "paths_shade.cuh"

using namespace rmr;

namespace {

// march steps per pass (PERF.md: 32 beat 1, 4, 8, 16, 64 and 128; for
// the recorder 32 beat 8 and 16)
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

// The policies of the lane machine: what a lane's work is and what it
// writes.  The render: the mean of its pixel into `out` ((ph, pw, 3)),
// and under the deferred sky each path's miss event into six (K, ph, pw)
// planes.
struct RenderOut {
  static constexpr bool kRecord = false;
  float* out;
  float* plane[6];  // thr_r, thr_g, thr_b, dir_x, dir_y, dir_z
  size_t stride;    // ph * pw
};

// The recorder: the rays of `n` planes in, and the banks of each ray:
// (t, mid, hit) at slot b * n + i, sd at slot (b * L + li) * n + i.
struct RecordOut {
  static constexpr bool kRecord = true;
  const float *ex, *ey, *ez, *dx, *dy, *dz;
  const int *px, *py, *sample;
  float* t;
  int* mid;
  int* hit;
  float* sd;
  int n;
};

struct Lane {
  MarchState m;  // the bounce or shadow segment in flight
  int state;
  // the pixel: its coordinates, its sum, the sample (path slot) k, the
  // channel ci of a dispersed sample and that sample's channel sum (a
  // recording lane: its ray's pixel, and the ray's index in `pix`)
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

__device__ __forceinline__ Ctx make_ctx(const PathArgs& a, const SceneRef& s, int sky_kind) {
  Ctx c;
  c.a = a;
  c.s = s;
  c.mp.max_steps = a.max_steps;
  c.mp.relax = a.relax;
  c.mp.max_dist = a.max_dist;
  c.mp.hit_eps = a.hit_eps;
  c.mp.step_multiply = a.step_multiply;
  c.mp.relax_omega = a.relax_omega;
  c.sky_kind = sky_kind;
  return c;
}

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
__device__ __forceinline__ void finish_pixel(const Ctx& c, Lane& L, const RenderOut& p) {
  float* o = p.out + 3 * L.pix;
  o[0] = L.acc.x * c.a.inv_n;
  o[1] = L.acc.y * c.a.inv_n;
  o[2] = L.acc.z * c.a.inv_n;
  L.state = kIdle;
}

// the pixel (lx, ly) of the patch: its first path
__device__ void start_pixel(const Ctx& c, Lane& L, const RenderOut& p, int lx, int ly) {
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
    finish_pixel(c, L, p);
  }
}

// ray i of the recorder's planes: its first bounce (none with max_bounces
// 0: the lane is free)
__device__ void start_ray(const Ctx& c, Lane& L, const RecordOut& p, int i) {
  L.pix = (size_t)i;
  L.px = (uint32_t)p.px[i];
  L.py = (uint32_t)p.py[i];
  L.sid = (uint32_t)p.sample[i];
  L.o = mk(p.ex[i], p.ey[i], p.ez[i]);
  L.d = mk(p.dx[i], p.dy[i], p.dz[i]);
  L.color = splat(1.0f);
  L.inside = 0.0f;
  L.b = 0;
  if (c.a.max_bounces > 0) {
    begin_bounce(c, L);
  } else {
    L.state = kIdle;
  }
}

// The path's end: its colour joins the pixel's sum (through the sample's
// channel sum under dispersion), its miss event goes to its bank slot;
// then the next path, or the pixel's mean.  A recording lane's ray is
// done.
template <class P>
__device__ void end_path(const Ctx& c, Lane& L, const P& p) {
  if constexpr (P::kRecord) {
    L.state = kIdle;
  } else {
    const PathArgs& a = c.a;
    const V3 pc = add(L.color, L.extra);
    if (c.sky_kind == kSkyDefer) {
      const size_t slot = (size_t)L.k * p.stride + L.pix;
      p.plane[0][slot] = L.miss_thr.x;
      p.plane[1][slot] = L.miss_thr.y;
      p.plane[2][slot] = L.miss_thr.z;
      p.plane[3][slot] = L.miss_dir.x;
      p.plane[4][slot] = L.miss_dir.y;
      p.plane[5][slot] = L.miss_dir.z;
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
      finish_pixel(c, L, p);
    }
  }
}

// after a hit and its NEE: the next bounce, or the path's end
template <class P>
__device__ __forceinline__ void after_hit(const Ctx& c, Lane& L, const P& p) {
  if (L.cont) {
    L.b += 1;
    if (L.b < c.a.max_bounces) {
      begin_bounce(c, L);
      return;
    }
  }
  end_path(c, L, p);
}

// A bounce ray's hit: the normal, the material, NEE's set-up, the
// roulette and the next ray (trace_rgb's loop body).
template <bool kExact, class P>
__device__ void shade(const Ctx& c, Lane& L, float t, int mid, const P& p) {
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
    L.nrng = rng_fork(rng, 7u);
    L.li = 0;
    if constexpr (!P::kRecord) {
      L.nee_thr = L.color;
      L.total = splat(0.0f);
    }
  }
  if (a.rr_start_bounce >= 0) {
    const float prob = fminf(fmaxf(fmaxf(L.color.x, fmaxf(L.color.y, L.color.z)), a.rr_min_prob), 1.0f);
    Rng rr = rng_fork(rng, 13u);
    const float u = rng_next(rr);
    const bool do_rr = active && L.b >= a.rr_start_bounce;
    const bool kill = do_rr && u >= prob;
    if (kill) {
      L.color = splat(0.0f);
    } else if (do_rr) {
      L.color = scale(L.color, 1.0f / prob);
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
    if constexpr (!P::kRecord) L.extra = add(L.extra, L.total);
  }
  after_hit(c, L, p);
}

// A finished shadow ray: its light's contribution joins the hit's sum (a
// recording lane banks its visibility); then the next light, or the sum
// joins the path's NEE radiance.
template <class P>
__device__ void resolve_light(const Ctx& c, Lane& L, const P& p) {
  int smid;
  bool shit;
  const float sd = march_result(L.m, smid, shit);
  const float dist_l = L.m.tmax;
  const int n = c.a.n_lights;
  if constexpr (P::kRecord) {
    p.sd[((size_t)L.b * n + L.li) * p.n + L.pix] = sd >= dist_l ? 3.4e38f : 0.0f;
  } else {
    const V3 ldir = L.m.d;
    const float cos_t = fmaxf(dot(ldir, L.nee_n), 0.0f);
    const float fall = light_table(c.s)[3 * n + L.li] / fmaxf(dist_l * dist_l, 1e-8f);
    const V3 contrib = scale(L.nee_thr, cos_t * fall / kPi);
    L.total = add(L.total, sd >= dist_l ? contrib : splat(0.0f));
  }
  L.li += 1;
  if (L.li < n) {
    begin_light(c, L);
    return;
  }
  if constexpr (!P::kRecord) L.extra = add(L.extra, L.total);
  after_hit(c, L, p);
}

// The event of a lane whose segment has ended (or whose path ended
// without a bounce).  A recording lane banks each bounce march's result.
template <bool kExact, class P>
__device__ void event(const Ctx& c, Lane& L, const P& p) {
  if (L.state == kShadow) {
    resolve_light(c, L, p);
    return;
  }
  if (L.state == kEnd) {
    end_path(c, L, p);
    return;
  }
  int mid;
  bool hit;
  const float t = march_result(L.m, mid, hit);
  if constexpr (P::kRecord) {
    const size_t k = (size_t)L.b * p.n + L.pix;
    p.t[k] = t;
    p.mid[k] = mid;
    p.hit[k] = hit ? 1 : 0;
  }
  if (hit) {
    shade<kExact>(c, L, t, mid, p);
    return;
  }
  if constexpr (!P::kRecord) {
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
  }
  end_path(c, L, p);
}

// The lanes of a persistent grid on a queue of `n_slots` slots: a lane
// with no work asks for the next slot and `take(q)` starts it there; a
// lane with work runs a pass, up to kUnroll march steps of its segment,
// then the events until it marches again.  A warp leaves once the queue
// is drained and all its lanes are free.
template <bool kExact, int kUnroll, class P, class Take>
__device__ __forceinline__ void run_lanes(const Ctx& c, Lane& L, const P& p, int* queue,
                                          int n_slots, Take take) {
  L.state = kIdle;
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
    if (L.state != kIdle) {
      for (int u = 0; u < kUnroll; ++u) {
        if (L.state != kIdle && march_live(L.m, c.mp)) march_advance(c.s, c.mp, L.m);
      }
      while (L.state != kIdle && !march_live(L.m, c.mp)) event<kExact>(c, L, p);
    }
  }
}

template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksWavefront) wavefront_paths_kernel(
    PathArgs a, SceneDims dims, int sky_kind, const float* __restrict__ corners,
    const float* __restrict__ fdata, const int* __restrict__ prog, RenderOut p,
    int* __restrict__ queue) {
  // the scene, the sky, the light table and the SH coefficients, once per
  // block in shared memory
  Ctx c = make_ctx(a, stage_scene(prog, fdata, dims), sky_kind);
  c.cam = load_camera(corners);
  Lane L;
  // a queue slot's pixel (none outside the patch)
  run_lanes<kExact, kWaveUnroll>(c, L, p, queue, queue_len(a.pw, a.ph), [&](int q) {
    int lx, ly;
    if (queue_pixel(a.pw, a.ph, q, lx, ly)) start_pixel(c, L, p, lx, ly);
  });
}

// The recorder: the same lanes on the ray queue (slot i is ray i).
template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksWavefront)
    record_wavefront_kernel(PathArgs a, SceneDims dims, const float* __restrict__ fdata,
                            const int* __restrict__ prog, RecordOut p, int* __restrict__ queue) {
  // the scene and its light table, once per block in shared memory
  const Ctx c = make_ctx(a, stage_scene(prog, fdata, dims), kSkyConst);
  Lane L;
  run_lanes<kExact, kWaveUnroll>(c, L, p, queue, p.n, [&](int i) { start_ray(c, L, p, i); });
}

// Launch kernel<true> (the exact normal) when normal_taps is 0, else
// kernel<false>, on a persistent grid for `n_slots` queue slots with the
// scene's shared memory; returns the CUDA error.
template <class K, class... Args>
cudaError_t launch_persistent(K exact_kernel, K kernel, const PathArgs* args,
                              const SceneDims* dims, int n_slots, cudaStream_t stream,
                              int device, Args... rest) {
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  K k = exact ? exact_kernel : kernel;
  int grid = 0;
  cudaError_t err = allow_smem(k, bytes);
  if (err == cudaSuccess) err = persistent_grid(k, bytes, device, n_slots, grid);
  if (err != cudaSuccess) return err;
  k<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, rest...);
  return cudaGetLastError();
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
  RenderOut p;
  p.out = out;
  float* planes[6] = {thr_r, thr_g, thr_b, dir_x, dir_y, dir_z};
  for (int i = 0; i < 6; ++i) {
    if (sky_kind == kSkyDefer && planes[i] == nullptr) return (int)cudaErrorInvalidValue;
    p.plane[i] = planes[i];
  }
  p.stride = (size_t)args->ph * args->pw;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(wavefront_paths_kernel<true>, wavefront_paths_kernel<false>, args,
                                dims, queue_len(args->pw, args->ph), stream, device, sky_kind,
                                corners, fdata, prog, p, queue);
}

// The wavefront recording entry: `n` rays given as planes (eye and
// direction float32, pixel coordinates and sample index int32), banked per
// bounce: `t` (float32), `mid` and `hit` (int32), each (max_bounces, n),
// and with NEE `sd` (float32, (max_bounces * n_lights, n)); the caller
// fills them with the miss values (and sd with 3.4e38) first.  Reads the
// march, shading, NEE and roulette fields of `args`.  `queue` is one int32
// on the device, zero before the launch (the ray queue's counter).
extern "C" int rmr_record_wavefront(const PathArgs* args, const SceneDims* dims, int n,
                                    const float* fdata, const int* prog, const float* ex,
                                    const float* ey, const float* ez, const float* dx,
                                    const float* dy, const float* dz, const int* px,
                                    const int* py, const int* sample, float* t, int* mid,
                                    int* hit, float* sd, int* queue, cudaStream_t stream,
                                    int device) {
  if (args->n_lights < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  const RecordOut p = {ex, ey, ez, dx, dy, dz, px, py, sample, t, mid, hit, sd, n};
  return (int)launch_persistent(record_wavefront_kernel<true>, record_wavefront_kernel<false>,
                                args, dims, n, stream, device, fdata, prog, p, queue);
}
