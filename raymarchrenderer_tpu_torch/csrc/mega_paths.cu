// RGB path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `render_fused_patch` in mega mode
// (raymarchrenderer_tpu/kernels/march.py:395, the pl.pallas_call whose
// `_tile_kernel` body is render/mega.py `trace_mega_paths`).  Its plain
// PyTorch version is raymarchrenderer_tpu_torch/render/mega.py
// `trace_mega_paths`, and the wrapper is
// raymarchrenderer_tpu_torch/kernels/march.py `render_fused_patch`.
//
// Design.  Each lane runs one pixel's own copy of the lane-state machine
// until its state reaches EXH, as mega_spectral.cu does: the peeled first
// march step, then bodies of `march_unroll` steps
// with a cheap pass (lazy miss test, shadow resolve, regeneration) every
// `regen_cadence` steps, and one shade + resolve + regen pass per body.  An
// exhausted lane is inert in every pass of the Pallas tile loop, and every
// random draw is keyed on the lane's own (px, py, sample, bounce) stream,
// so the thread reproduces its lane exactly; with `lazy_miss` the pass
// boundaries are semantics, so the schedule is kept, not approximated.
// The deferred-sky and recording instantiations run a persistent grid:
// only as many blocks as stay resident, each lane taking the patch's
// pixels one after another from a global queue (scene_map.cuh), so a warp
// no longer lives as long as the longest of 32 fixed chains.  The constant
// and SH skies run it when the caller hands `rmr_mega_paths` a queue
// counter (`Queued<R>`), which the wrapper does when a lane has few paths
// to run, and keep one lane per pixel otherwise, where each lane's many
// paths even out its chain (`kQueue`).  Either way a pixel's chain runs
// in one thread, op for op, and each output slot has one writer, so the
// output is the same bytes.
// The scene (objects, materials, lights, sky) is staged once per block in
// shared memory, and the object interpreter forwards node values in
// registers (scene_map.cuh).
//
//  * Materials are data, like the objects: kernels/scene_program.py
//    compiles each material graph into register-machine instructions, and
//    a thread evaluates only its hit's material, starting its draw counter
//    at that material's `rng_base` (the plain version evaluates every
//    material with one stream, so material i draws after materials 0..i-1).
//  * Next-event estimation: a non-terminated hit stages a shadow ray toward
//    light 0 and marches it as another segment of the same loop (SHADOW ->
//    SH_LIT / SH_OCC, banked by `resolve`).  The plain version stashes
//    every light's (dir, t_max, contrib) at shade time; a thread instead
//    keeps the hit point, normal, pre-roulette throughput and the NEE
//    stream, and recomputes light li's segment when the chain reaches it:
//    the same ops on the same inputs, so the same values, at a state size
//    that does not grow with the light count.  The light table sits in
//    shared memory with the rest of the scene (scene_map.cuh
//    `stage_scene`), as many lights as the scene has.
//  * Russian roulette (`rr_start_bounce >= 0`) and dispersion (the path
//    counter over (sample, channel) pairs) as in the plain version.
//  * The sky is a policy of the lane machine (a template argument, like
//    the recorder's banks below, so each instantiation keeps only its own
//    code): `NoBanks` multiplies a miss by the constant sky, `ShSky` by
//    the SH sky evaluated in-kernel (`sh_eval`, the 48 coefficients of the
//    staged tail), and `DeferSky` (entry `rmr_mega_paths_defer`, the
//    TPU kernel's mega + defer_sky branch, raymarchrenderer_tpu/kernels/
//    march.py:130-165) parks a miss as kWaitMiss; the next regeneration
//    banks the path's throughput and its packed equirect (u, v) (the JAX
//    package's 16-bit quantisation through `atan2_poly`, op for op) into
//    slot s_idx of four global-memory planes, which the wrapper zero-fills
//    and composites after the launch (`composite_uv`).  A lane's slots
//    have one writer each, so no atomics.  On the TPU the banks were
//    K-deep register carries, a Mosaic constraint this kernel does not
//    have.  Bound: at the env main path's launch (1024^2, 32 paths) the
//    banks are 16 bytes per path and pixel, 512 MiB = 0.16 ms at
//    3.35 TB/s, against the operations' bound (PERF.md).
//
// Bound on the H100: FP32 issue and warp divergence, not bytes: a launch
// reads a few hundred bytes of scene and writes 12 bytes per pixel, and
// every pixel runs about 65 interpreted map evaluations per sample.  At
// 1024^2 x 128 samples of sphere_on_floor the FP32 operation bound is
// 7.7 ms against 0.004 ms for the bytes, and the kernel takes about 370 ms
// (PERF.md; NVIDIA H100 80GB HBM3, 700 W): it is latency-bound, and more
// resident warps help (the launch bounds in scene_map.cuh).
// It stays exact: no FMA contraction (built with --fmad=false, no fast
// math), 1/sqrtf for normalisation, and the scene and materials
// interpreted.  Per-scene code generation and FMA contraction are left for
// later work.
//
// The recording entry `rmr_record_paths` replaces the TPU kernel
// `_record_mega` (raymarchrenderer_tpu/kernels/record.py:289, the
// pl.pallas_call at :395, whose body is trace_mega_paths(record_banks)).
// Its plain version is render/mega.py `trace_mega_paths(record_banks=True)`
// and its wrapper kernels/record.py `trace_record_fused`.  It runs the same
// lane machine, instantiated with `Banks` instead of `NoBanks` (a template
// argument, so the render kernel compiles to the code it had without
// banks): a shaded hit writes (t, material, 1) to slot bounce * P + path of
// the (B * P, ph, pw) banks, a resolved shadow ray writes its visibility
// (3.4e38 lit, 0 occluded) to slot ((bounce - 1) * P + path) * L + light,
// and the lane evaluates no sky and writes no image.  Each slot of a pixel
// has one writer, so no atomics; neighbouring threads write neighbouring
// addresses of a slot only when they are at the same (bounce, path), so
// the stores are partly coalesced.  The wrapper fills the banks with the
// miss values first.  Bound: bytes are 12 per (bounce, path) slot and
// pixel (plus 4 per light with NEE), written once: 201 MB = 0.06 ms at
// 3.35 TB/s for 1024^2 pixels x 4 samples x 4 bounces; the operations (the
// map evaluations the lanes make, counted by the plain version's `work`)
// bind, as for the render (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "paths_shade.cuh"

using namespace rmr;

namespace {

// lane states, as in render/mega.py
constexpr int kMarch = 0;
constexpr int kWait = 1;
constexpr int kRegen = 2;
constexpr int kShadow = 4;
constexpr int kShLit = 5;
constexpr int kShOcc = 6;
constexpr int kExh = 7;
constexpr int kWaitMiss = -1;  // a parked miss of the deferred sky

// The lane machine's policies: what a lane banks and which sky a missed
// bounce ray meets.  `kOn` turns on the recording (banks of march
// residuals, no sky, no image); `kSky` is the sky of a render; `kExact`
// the exact normal (ExactNormal<policy>, normal_taps = 0); `kQueue` a
// persistent grid on the pixel queue (scene_map.cuh) instead of one
// thread per pixel: where the lanes' chains vary most (the deferred sky's
// paths end on their first miss; the recorder's launches are short; a
// launch of few paths a lane), the queue pays; on the constant and SH
// skies at many paths a lane one thread per pixel is faster (PERF.md), so
// each has a queued twin, `Queued<R>`, that the caller picks.  Each is a
// template argument, so every instantiation compiles only its own code.

// The render with the constant sky: no banks.
struct NoBanks {
  static constexpr bool kOn = false;
  static constexpr int kSky = kSkyConst;
  static constexpr bool kExact = false;
  static constexpr bool kQueue = false;
};

// The render with the SH sky, its coefficients in the staged tail
// (`sh_coeffs`).
struct ShSky {
  static constexpr bool kOn = false;
  static constexpr int kSky = kSkySh;
  static constexpr bool kExact = false;
  static constexpr bool kQueue = false;
};

// A render policy on the persistent grid of the pixel queue: the constant
// or the SH sky of `rmr_mega_paths` given a queue counter.
template <class R>
struct Queued : R {
  static constexpr bool kQueue = true;
};

// The render with an env image (the deferred sky): a missed bounce ray
// parks as kWaitMiss, and the next regeneration banks the path's
// throughput and packed (u, v) at slot s_idx of four global-memory
// planes, at this lane's pixel.
struct DeferSky {
  static constexpr bool kOn = false;
  static constexpr int kSky = kSkyDefer;
  static constexpr bool kExact = false;
  static constexpr bool kQueue = true;
  float* thr_r;
  float* thr_g;
  float* thr_b;
  int* uv;
  size_t plane;  // ph * pw
  size_t pix;    // the lane's pixel in the patch
};

// The record banks of one recording launch, at this lane's pixel.
struct Banks {
  static constexpr bool kOn = true;
  static constexpr int kSky = kSkyConst;  // unread: a recording meets no sky
  static constexpr bool kExact = false;
  static constexpr bool kQueue = true;
  float* t;
  int* mid;
  int* hit;
  float* sd;
  size_t plane;  // ph * pw
  size_t pix;    // the lane's pixel in the patch
  int paths;     // P: samples, or (sample, channel) pairs with dispersion
};

}  // namespace

// ---- the lane-state machine (render/mega.py trace_mega_paths) -------------

struct Lane {
  V3 o, d, thr, acc;
  float t, inside, omega, prev_r, step_len;
  int bounce, s_idx, state, steps, gstep;
  // NEE: the shadow segment, its pending contribution, the path's banked
  // NEE radiance, the state to resume, the light counter, and what the
  // next light's segment is recomputed from
  V3 sh_o, sh_d, contrib, extra, nee_p, nee_n, nee_thr;
  float seg_tmax;
  int resume, li;
  Rng nee_rng;
};

struct Ctx {
  PathArgs a;
  SceneRef s;  // the light table and the sky in its tail (paths_shade.cuh)
  uint32_t px, py;
  Camera cam;
};

// (primary stream, shade stream) of path counter s_idx
__device__ __forceinline__ uint32_t prim_stream(const Ctx& c, int s_idx) {
  return c.a.sample0 + (uint32_t)(c.a.dispersion ? s_idx / 3 : s_idx);
}
__device__ __forceinline__ uint32_t shade_stream(const Ctx& c, int s_idx) {
  if (!c.a.dispersion) return c.a.sample0 + (uint32_t)s_idx;
  return prim_stream(c, s_idx) * 4u + (uint32_t)(s_idx % 3) + 1u;
}
__device__ __forceinline__ V3 lane_channels(const Ctx& c, int s_idx) {
  if (!c.a.dispersion) return splat(1.0f);
  const int ci = s_idx % 3;
  return mk(ci == 0 ? 1.0f : 0.0f, ci == 1 ? 1.0f : 0.0f, ci == 2 ? 1.0f : 0.0f);
}

// A missed bounce ray's throughput times the sky (the constant or the SH
// sky; a recording and the deferred sky leave it).
template <class R>
__device__ __forceinline__ void sky_miss(const Ctx& c, Lane& L) {
  if constexpr (!R::kOn && R::kSky == kSkyConst) L.thr = scale(L.thr, sky_power(c.s));
  if constexpr (!R::kOn && R::kSky == kSkySh) L.thr = mul(L.thr, sh_eval(sh_coeffs(c.s), L.d));
}

// The state a missed bounce ray parks in.
template <class R>
constexpr int kMissState = (!R::kOn && R::kSky == kSkyDefer) ? kWaitMiss : kRegen;

__device__ __forceinline__ void reset_segment(const Ctx& c, Lane& L) {
  L.t = 0.0f;
  L.steps = c.a.lazy_miss ? L.gstep : 0;
  if (c.a.relax) {
    L.omega = c.a.relax_omega;
    L.prev_r = 0.0f;
    L.step_len = 0.0f;
  }
}

template <class R>
__device__ void march_step(const Ctx& c, Lane& L) {
  const PathArgs& a = c.a;
  if (a.lazy_miss) {
    L.gstep += 1;
  } else {
    L.steps += 1;  // unconditional, as in the plain version
  }
  const bool shadow = L.state == kShadow;
  if (L.state != kMarch && !shadow) return;
  const V3 o = shadow ? L.sh_o : L.o;
  const V3 d = shadow ? L.sh_d : L.d;
  const float dist_mult = shadow ? 1.0f : 1.0f - 2.0f * L.inside;
  const V3 p = add(o, scale(d, L.t));
  const float dist = map_dist(c.s, a.max_dist, p) * dist_mult;
  const bool fail = a.relax && L.omega > 1.0f && (dist + L.prev_r < L.step_len);
  bool hit = !fail && dist < a.hit_eps;
  bool miss = false;
  if (a.lazy_miss) {
    // a shadow ray past its light must not occlude (mark_misses parks it)
    if (shadow && !(L.t < L.seg_tmax)) hit = false;
  } else {
    miss = !fail && !hit && (L.t >= L.seg_tmax || L.steps >= a.max_steps);
  }
  if (hit) L.state = shadow ? kShOcc : kWait;
  if (miss) {
    if (!shadow) sky_miss<R>(c, L);
    L.state = shadow ? kShLit : kMissState<R>;  // an exhausted shadow ray is lit
  }
  const bool still = !hit && !miss;
  if (a.relax) {
    const float new_len = fail ? L.step_len * a.one_minus_omega : dist * L.omega;
    if (fail) L.omega = 1.0f;
    if (still) {
      L.prev_r = fabsf(dist);
      L.step_len = fabsf(new_len);
      L.t = L.t + new_len;
    }
  } else if (still) {
    L.t = L.t + dist * a.step_multiply;
  }
}

template <class R>
__device__ __forceinline__ void mark_misses(const Ctx& c, Lane& L) {
  const bool shadow = L.state == kShadow;
  if ((L.state == kMarch || shadow) &&
      (L.t >= L.seg_tmax || L.gstep - L.steps >= c.a.max_steps)) {
    if (!shadow) sky_miss<R>(c, L);
    L.state = shadow ? kShLit : kMissState<R>;
  }
}

// the shadow segment toward a jittered point of light li
__device__ void light_segment(const Ctx& c, Lane& L, int li) {
  Rng lrng = rng_fork(L.nee_rng, 101u + (uint32_t)li);
  const int n = c.a.n_lights;
  const float* lights = light_table(c.s);
  const V3 lpos = mk(lights[3 * li], lights[3 * li + 1], lights[3 * li + 2]);
  const float lpower = lights[3 * n + li];
  const float lradius = lights[4 * n + li];
  const float u1 = rng_next(lrng);
  const float u2 = rng_next(lrng);
  const V3 target = add(lpos, scale(uniform_sphere(u1, u2), lradius));
  const V3 delta = sub(target, L.nee_p);
  const float dist_l = length(delta);
  const float dd = fmaxf(dist_l, 1e-8f);
  const V3 ldir = mk(delta.x / dd, delta.y / dd, delta.z / dd);
  const float cos_t = fmaxf(dot(ldir, L.nee_n), 0.0f);
  const float fall = lpower / fmaxf(dist_l * dist_l, 1e-8f);
  L.sh_d = ldir;
  L.seg_tmax = dist_l;
  L.contrib = scale(L.nee_thr, cos_t * fall / kPi);
}

template <class R>
__device__ void shade(const Ctx& c, Lane& L, const R& r) {
  if (L.state != kWait) return;
  const PathArgs& a = c.a;
  ShadeIn in;
  in.origin = L.o;
  in.dir = L.d;
  in.t = L.t;
  in.inside = L.inside;
  in.hit = add(L.o, scale(L.d, L.t));
  const int mid = map_mid(c.s, a.max_dist, in.hit);
  if constexpr (R::kOn) {
    const size_t k = (size_t)(L.bounce * r.paths + L.s_idx) * r.plane + r.pix;
    r.t[k] = L.t;
    r.mid[k] = mid;
    r.hit[k] = 1;
  }
  in.normal = get_normal<R::kExact>(c.s, a.max_dist, a.normal_eps, a.normal_taps, in.hit);
  in.channels = lane_channels(c, L.s_idx);
  Rng rng = rng_make(a.seed, c.px, c.py, shade_stream(c, L.s_idx), (uint32_t)L.bounce);
  const ShadeOut so = eval_material(c.s, mid, in, rng);
  L.thr = mul(L.thr, so.color);
  const bool new_inside = so.inside.x > 0.5f;
  L.inside = new_inside ? 1.0f : 0.0f;
  const bool term = is_zero(so.dir);
  const int bounce0 = L.bounce;
  L.bounce += 1;
  bool done = term || L.bounce >= a.max_bounces;
  const V3 pre_rr_thr = L.thr;  // NEE sees the throughput before the roulette
  if (a.rr_start_bounce >= 0) {
    // the roulette runs on every continuing hit, the last bounce included,
    // at the lane's bounce before the increment
    const float p = fminf(fmaxf(fmaxf(L.thr.x, fmaxf(L.thr.y, L.thr.z)), a.rr_min_prob), 1.0f);
    Rng rr = rng_fork(rng, 13u);
    const float u = rng_next(rr);
    const bool do_rr = !term && bounce0 >= a.rr_start_bounce;
    const bool kill = do_rr && u >= p;
    if (kill) {
      L.thr = splat(0.0f);
    } else if (do_rr) {
      L.thr = scale(L.thr, 1.0f / p);
    }
    done = done || kill;
  }
  L.state = done ? kRegen : kMarch;
  const float off = new_inside ? -a.inside_offset : a.exit_offset;
  L.o = is_zero(so.hit) ? add(in.hit, scale(in.normal, off)) : so.hit;
  L.d = so.dir;
  reset_segment(c, L);
  if (a.nee && !term) {
    L.nee_p = in.hit;
    L.nee_n = in.normal;
    L.nee_thr = pre_rr_thr;
    L.nee_rng = rng_fork(rng, 7u);
    L.resume = L.state;
    L.state = kShadow;
    L.li = 0;
    L.sh_o = add(in.hit, scale(in.normal, a.surface_offset));
    light_segment(c, L, 0);
  }
}

// bank a finished shadow ray and chain to the next light, or resume
template <class R>
__device__ void resolve(const Ctx& c, Lane& L, const R& r) {
  if (L.state != kShLit && L.state != kShOcc) return;
  if constexpr (R::kOn) {
    // L.bounce was already incremented by the shade that staged the ray
    const size_t slot = (size_t)((L.bounce - 1) * r.paths + L.s_idx) * c.a.n_lights + L.li;
    r.sd[slot * r.plane + r.pix] = L.state == kShLit ? 3.4e38f : 0.0f;
  }
  if (L.state == kShLit) L.extra = add(L.extra, L.contrib);
  const int li2 = L.li + 1;
  if (li2 < c.a.n_lights) {
    light_segment(c, L, li2);
    L.state = kShadow;
    L.li = li2;
  } else {
    L.state = L.resume;
    L.seg_tmax = c.a.max_dist;
    L.li = 0;
  }
  reset_segment(c, L);
}

// The deferred sky: a parked miss banks its throughput and its
// direction's equirect (u, v), the JAX package's quantisation op for op
// (atan2_poly, phi wrapped to [0, 2 pi), u = phi / 2 pi, v = 1 - (y * 0.5 +
// 0.5), truncated to int32 after * 65536, clipped to [0, 65535], packed
// (u << 16) | v), at slot s_idx of its pixel.
template <class R>
__device__ __forceinline__ void bank_miss(const Lane& L, const R& r) {
  if constexpr (!R::kOn && R::kSky == kSkyDefer) {
    if (L.state != kWaitMiss) return;
    float phi = atan2_poly(L.d.z, L.d.x);
    if (phi < 0.0f) phi = phi + kTwoPi;
    const float uu = phi / kTwoPi;
    const float vv = 1.0f - (L.d.y * 0.5f + 0.5f);
    int ui = (int)(uu * 65536.0f);
    int vi = (int)(vv * 65536.0f);
    ui = ui < 0 ? 0 : (ui > 65535 ? 65535 : ui);
    vi = vi < 0 ? 0 : (vi > 65535 ? 65535 : vi);
    const size_t k = (size_t)L.s_idx * r.plane + r.pix;
    r.thr_r[k] = L.thr.x;
    r.thr_g[k] = L.thr.y;
    r.thr_b[k] = L.thr.z;
    r.uv[k] = (int)(((uint32_t)ui << 16) | (uint32_t)vi);
  }
}

template <class R>
__device__ void regen(const Ctx& c, Lane& L) {
  // a parked miss of the deferred sky (banked by bank_miss) respawns too;
  // only its NEE radiance joins the sum, the sky term is the composite's
  constexpr bool kDefer = !R::kOn && R::kSky == kSkyDefer;
  const bool parked_miss = kDefer && L.state == kWaitMiss;
  if (L.state != kRegen && !parked_miss) return;
  if constexpr (kDefer) {
    if (parked_miss) {
      if (c.a.nee) L.acc = add(L.acc, L.extra);
    } else {
      L.acc = add(L.acc, c.a.nee ? add(L.thr, L.extra) : L.thr);
    }
  } else if constexpr (!R::kOn) {
    L.acc = add(L.acc, c.a.nee ? add(L.thr, L.extra) : L.thr);
  }
  L.s_idx += 1;
  const int n_paths = c.a.dispersion ? 3 * c.a.n_samples : c.a.n_samples;
  if (L.s_idx >= n_paths) {
    L.state = kExh;
    return;
  }
  L.state = kMarch;
  L.o = c.cam.eye;
  L.d = primary_ray(c.cam, c.a.seed, c.px, c.py, prim_stream(c, L.s_idx), c.a.width,
                    c.a.height);
  L.thr = lane_channels(c, L.s_idx);
  L.bounce = 0;
  L.inside = 0.0f;
  L.extra = splat(0.0f);
  reset_segment(c, L);
}

template <class R>
__device__ void cheap_pass(const Ctx& c, Lane& L, const R& r) {
  if (c.a.lazy_miss) mark_misses<R>(c, L);
  if (c.a.nee) resolve(c, L, r);
  bank_miss(L, r);
  regen<R>(c, L);
}

template <class R>
__device__ void body(const Ctx& c, Lane& L, const R& r) {
  const PathArgs& a = c.a;
  if (a.regen_cadence > 0 && a.regen_cadence < a.march_unroll) {
    const int n_sub = a.march_unroll / a.regen_cadence;
    for (int sub = 0; sub < n_sub; ++sub) {
      for (int k = 0; k < a.regen_cadence; ++k) march_step<R>(c, L);
      if (sub < n_sub - 1) cheap_pass(c, L, r);
    }
  } else {
    for (int k = 0; k < a.march_unroll; ++k) march_step<R>(c, L);
  }
  if (a.lazy_miss) mark_misses<R>(c, L);
  shade(c, L, r);
  if (a.nee) resolve(c, L, r);
  bank_miss(L, r);
  regen<R>(c, L);
}

// A lane's start on the pixel of `c`: the first path's primary ray, then
// the peeled first march step; `body` runs until the state reaches EXH,
// with the sum over the lane's paths in L.acc (a recording lane's stays
// zero: it leaves its banks).
template <class R>
__device__ __forceinline__ void start_lane(const Ctx& c, Lane& L) {
  L.o = c.cam.eye;
  L.d = primary_ray(c.cam, c.a.seed, c.px, c.py, prim_stream(c, 0), c.a.width, c.a.height);
  L.thr = lane_channels(c, 0);
  L.acc = splat(0.0f);
  L.t = 0.0f;
  L.inside = 0.0f;
  L.omega = c.a.omega0;
  L.prev_r = 0.0f;
  L.step_len = 0.0f;
  L.bounce = 0;
  L.s_idx = 0;
  L.state = kMarch;
  L.steps = 0;
  L.gstep = 0;
  L.sh_o = L.sh_d = L.contrib = L.extra = splat(0.0f);
  L.nee_p = L.nee_n = L.nee_thr = splat(0.0f);
  L.seg_tmax = c.a.max_dist;
  L.resume = 0;
  L.li = 0;
  L.nee_rng = rng_make(0u, 0u, 0u, 0u, 0u);
  march_step<R>(c, L);  // the peeled first step
}

// ---- launch ----------------------------------------------------------------

// One kernel for every entry: R = NoBanks or ShSky (or its Queued twin)
// renders into `out`, DeferSky renders the raw sum without the sky into
// `out` and banks the misses, Banks records into its banks.  Each lane
// runs one pixel's whole chain at a time, as a thread of a
// one-pixel-per-thread launch would: with R::kQueue the grid is
// persistent and a lane takes the next pixel from the queue when its
// chain ends, else lane q of the grid has queue slot q.
template <class R>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
    mega_paths_kernel(PathArgs a, SceneDims dims, const float* __restrict__ corners,
                      const float* __restrict__ fdata, const int* __restrict__ prog,
                      float* __restrict__ out, R banks, int* __restrict__ queue) {
  // the scene, its light table and its sky, once per block in shared memory
  const SceneRef s = stage_scene(prog, fdata, dims);
  Ctx c;
  c.a = a;
  c.s = s;
  c.cam = load_camera(corners);
  const int n_slots = queue_len(a.pw, a.ph);
  R r = banks;
  Lane L;
  size_t pix = 0;
  // start the lane on queue slot q's pixel; false outside the patch
  auto start = [&](int q) {
    int lx, ly;
    if (!queue_pixel(a.pw, a.ph, q, lx, ly)) return false;
    c.px = (uint32_t)(a.ox + lx);
    c.py = (uint32_t)(a.oy + ly);
    pix = (size_t)ly * a.pw + lx;
    if constexpr (R::kOn || R::kSky == kSkyDefer) r.pix = pix;
    start_lane<R>(c, L);
    return true;
  };
  auto finish = [&]() {
    if constexpr (!R::kOn) {
      float* o = out + 3 * pix;
      o[0] = L.acc.x * a.inv_n;
      o[1] = L.acc.y * a.inv_n;
      o[2] = L.acc.z * a.inv_n;
    }
  };
  if constexpr (!R::kQueue) {
    const int q = blockIdx.x * kBlockThreads + threadIdx.x;
    if (q >= n_slots || !start(q)) return;
    while (L.state < kExh) body(c, L, r);
    finish();
  } else {
    bool live = false, drained = false;
    for (;;) {
      const bool ask = !live && !drained;
      const int q = take_slot(queue, ask);
      if (ask) {
        if (q >= n_slots) {
          drained = true;
        } else {
          live = start(q);
        }
      }
      if (__all_sync(0xffffffffu, drained && !live)) break;
      if (!live) continue;
      body(c, L, r);
      if (L.state >= kExh) {
        live = false;
        finish();
      }
    }
  }
}

// Launch the lane machine of policy R, or of ExactNormal<R> when
// normal_taps is 0, with the scene's shared memory: on a persistent grid
// fed by the zeroed counter `queue` (R::kQueue), else one lane per queue
// slot; returns the CUDA error.
template <class R>
cudaError_t launch_mega(const PathArgs* args, const SceneDims* dims, const float* corners,
                        const float* fdata, const int* prog, float* out, const R& banks,
                        int* queue, cudaStream_t stream, int device) {
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  const int n_slots = queue_len(args->pw, args->ph);
  int grid = (n_slots + kBlockThreads - 1) / kBlockThreads;
  if (exact) {
    auto kernel = mega_paths_kernel<ExactNormal<R>>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err == cudaSuccess && R::kQueue) {
      err = persistent_grid(kernel, bytes, device, n_slots, grid);
    }
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, corners, fdata, prog, out,
                                                   ExactNormal<R>(banks), queue);
  } else {
    auto kernel = mega_paths_kernel<R>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err == cudaSuccess && R::kQueue) {
      err = persistent_grid(kernel, bytes, device, n_slots, grid);
    }
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, corners, fdata, prog, out, banks,
                                                   queue);
  }
  return cudaGetLastError();
}

// Plain C entry point for ctypes.  `args` and `dims` are host pointers
// (`dims` the sizes of the scene's buffers, scene_map.cuh SceneDims); the
// buffers are device pointers on CUDA device `device`; `out` is (ph, pw,
// 3) float32.  The library carries its own (static) CUDA runtime, so it
// selects the device itself before launching on `stream`.  Returns the
// first CUDA error (0 on success), and cudaErrorInvalidValue for a scene
// whose tables exceed the block's shared memory.  `sky_kind` picks the
// constant or the SH sky; an env image (kSkyDefer) takes
// rmr_mega_paths_defer and is refused here.  A null `queue` runs one lane
// per pixel; otherwise `queue` is one int32 on the device, zero before the
// launch, and the lanes run a persistent grid on the pixel queue
// (`Queued<R>`).  Both grids give the same bytes.
extern "C" int rmr_mega_paths(const PathArgs* args, const SceneDims* dims, const float* corners,
                              const float* fdata, const int* prog, float* out, int sky_kind,
                              int* queue, cudaStream_t stream, int device) {
  if (args->n_lights < 0) return (int)cudaErrorInvalidValue;
  if (sky_kind != kSkyConst && sky_kind != kSkySh) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (sky_kind == kSkySh) {
    if (queue) {
      return (int)launch_mega(args, dims, corners, fdata, prog, out, Queued<ShSky>(), queue,
                              stream, device);
    }
    return (int)launch_mega(args, dims, corners, fdata, prog, out, ShSky(), nullptr, stream,
                            device);
  }
  if (queue) {
    return (int)launch_mega(args, dims, corners, fdata, prog, out, Queued<NoBanks>(), queue,
                            stream, device);
  }
  return (int)launch_mega(args, dims, corners, fdata, prog, out, NoBanks(), nullptr, stream,
                          device);
}

// The deferred-sky entry (replaces the TPU kernel's mega + defer_sky
// branch, raymarchrenderer_tpu/kernels/march.py:130-165): as
// rmr_mega_paths for an env-image scene, but
// `out` gets the raw per-pixel sum without the sky (times inv_n, which the
// wrapper sets to 1), and each path that misses banks its throughput into
// `thr_r`, `thr_g`, `thr_b` (float32) and its packed (u, v) into `uv`
// (int32), each (P, ph, pw), P = n_samples (3 * n_samples with
// dispersion), at its path's slot; the caller zero-fills them first, so
// thr = 0 marks a slot whose path ended on a hit.  `queue` is one int32
// on the device, zero before the launch (the pixel queue's counter).
extern "C" int rmr_mega_paths_defer(const PathArgs* args, const SceneDims* dims,
                                    const float* corners, const float* fdata, const int* prog,
                                    float* out, float* thr_r, float* thr_g, float* thr_b,
                                    int* uv, int* queue, cudaStream_t stream, int device) {
  if (args->n_lights < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DeferSky banks;
  banks.thr_r = thr_r;
  banks.thr_g = thr_g;
  banks.thr_b = thr_b;
  banks.uv = uv;
  banks.plane = (size_t)args->ph * args->pw;
  banks.pix = 0;
  return (int)launch_mega(args, dims, corners, fdata, prog, out, banks, queue, stream, device);
}

// The recording entry: as rmr_mega_paths, but the lanes bank their march
// residuals into `t` (float32), `mid` and `hit` (int32), each
// (max_bounces * P, ph, pw) with P = n_samples (3 * n_samples with
// dispersion), and with NEE their shadow visibility into `sd` (float32,
// (max_bounces * P * n_lights, ph, pw)); the caller fills them with the
// miss values first.  No image is written.  `queue` as for
// rmr_mega_paths_defer.
extern "C" int rmr_record_paths(const PathArgs* args, const SceneDims* dims, const float* corners,
                                const float* fdata, const int* prog, float* t, int* mid, int* hit,
                                float* sd, int* queue, cudaStream_t stream, int device) {
  if (args->n_lights < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Banks banks;
  banks.t = t;
  banks.mid = mid;
  banks.hit = hit;
  banks.sd = sd;
  banks.plane = (size_t)args->ph * args->pw;
  banks.pix = 0;
  banks.paths = args->dispersion ? 3 * args->n_samples : args->n_samples;
  return (int)launch_mega(args, dims, corners, fdata, prog, nullptr, banks, queue, stream,
                          device);
}
