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
// Design.  One thread per pixel of the patch, running the JAX body
// literally: for each sample the jittered primary ray, then `trace_rgb`'s
// bounce loop: the strict per-step march of march_ray.cuh (the plain
// version's `march`), the normal, the hit's material through the material
// interpreter of paths_shade.cuh from its rng_base, next-event estimation
// (one shadow march per light toward a jittered point, capped at the
// light's distance, `light_ray`), the roulette, and on a miss the sky:
// the constant, the SH sky (`sh_eval`, 48 coefficients of the staged tail)
// or, for an env image, the miss event banked for the composite.  Under
// dispersion a sample is three one-channel paths sharing its primary ray,
// with shade streams s * 4 + ci + 1.  A path that has ended changes
// nothing in the plain version's later (masked) bounces, so the thread
// stops there.
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
// Bound on the H100: like the megakernel, the interpreted map evaluations
// (FP32 issue, divergent); a launch reads a few hundred bytes of scene and
// writes 12 bytes per pixel (plus 24 per slot and pixel with the deferred
// sky).  Without the megakernel's in-loop regeneration a warp waits for
// its slowest path every sample, which is why the JAX package renders in
// mega mode; this mode exists for parity and is kept simple: its calls to
// eval_material and get_normal are real calls.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paths_shade.cuh"

using namespace rmr;

namespace {

struct Ctx {
  PathArgs a;
  SceneRef s;
  MarchParams mp;
  int sky_kind;  // the light table and the sky in the scene's tail
  uint32_t px, py;
};

// one path's result: its colour (plus NEE), and its miss event
struct Path {
  V3 color, miss_thr, miss_dir;
};

// trace_rgb for one lane: the path from the eye along d0 with shade stream
// `sid` and colour mask `ch`; kExact: the exact normal (normal_taps = 0).
template <bool kExact>
__device__ Path trace_path(const Ctx& c, V3 eye, V3 d0, uint32_t sid, V3 ch) {
  const PathArgs& a = c.a;
  const bool defer = c.sky_kind == kSkyDefer;
  Path out;
  out.miss_thr = splat(0.0f);
  out.miss_dir = splat(0.0f);
  V3 o = eye, d = d0, color = ch, extra = splat(0.0f);
  float inside = 0.0f;
  for (int b = 0; b < a.max_bounces; ++b) {
    int mid;
    bool hit;
    const float t = march_ray(c.s, c.mp, o, d, 1.0f - 2.0f * inside, a.max_dist, true, mid, hit);
    if (!hit) {
      if (defer) {
        // bank the miss event; the composite adds miss_thr * sky(miss_dir)
        out.miss_thr = color;
        out.miss_dir = d;
        color = mul(color, splat(0.0f));
      } else if (c.sky_kind == kSkySh) {
        color = mul(color, sh_eval(sh_coeffs(c.s), d));
      } else {
        color = mul(color, splat(sky_power(c.s)));
      }
      break;
    }
    ShadeIn in;
    in.origin = o;
    in.dir = d;
    in.t = t;
    in.inside = inside;
    in.hit = add(o, scale(d, t));
    in.normal = get_normal<kExact>(c.s, a.max_dist, a.normal_eps, a.normal_taps, in.hit);
    in.channels = ch;
    Rng rng = rng_make(a.seed, c.px, c.py, sid, (uint32_t)b);
    const ShadeOut so = eval_material(c.s, mid, in, rng);
    const V3 throughput = color;
    color = mul(color, so.color);
    const bool new_inside = so.inside.x > 0.5f;
    inside = new_inside ? 1.0f : 0.0f;
    bool active = !is_zero(so.dir);
    if (a.nee && active) {
      // _direct_light: every light's shadow ray, summed, then added
      const Rng nrng = rng_fork(rng, 7u);
      const V3 o_sh = add(in.hit, scale(in.normal, a.surface_offset));
      V3 total = splat(0.0f);
      for (int li = 0; li < a.n_lights; ++li) {
        V3 ldir;
        const float dist_l = light_ray(light_table(c.s), a.n_lights, li, nrng, in.hit, ldir);
        int smid;
        bool shit;
        const float sd = march_ray(c.s, c.mp, o_sh, ldir, 1.0f, dist_l, true, smid, shit);
        const float cos_t = fmaxf(dot(ldir, in.normal), 0.0f);
        const float fall =
            light_table(c.s)[3 * a.n_lights + li] / fmaxf(dist_l * dist_l, 1e-8f);
        const V3 contrib = scale(mul(throughput, so.color), cos_t * fall / kPi);
        total = add(total, sd >= dist_l ? contrib : splat(0.0f));
      }
      extra = add(extra, total);
    }
    if (a.rr_start_bounce >= 0) {
      const float p = fminf(fmaxf(fmaxf(color.x, fmaxf(color.y, color.z)), a.rr_min_prob), 1.0f);
      Rng rr = rng_fork(rng, 13u);
      const float u = rng_next(rr);
      const bool do_rr = active && b >= a.rr_start_bounce;
      const bool kill = do_rr && u >= p;
      if (kill) {
        color = splat(0.0f);
      } else if (do_rr) {
        color = scale(color, 1.0f / p);
      }
      active = active && !kill;
    }
    if (!active) break;
    const float off = new_inside ? -a.inside_offset : a.exit_offset;
    o = is_zero(so.hit) ? add(in.hit, scale(in.normal, off)) : so.hit;
    d = so.dir;
  }
  out.color = add(color, extra);
  return out;
}

__device__ __forceinline__ V3 one_hot(uint32_t ci) {
  return mk(ci == 0u ? 1.0f : 0.0f, ci == 1u ? 1.0f : 0.0f, ci == 2u ? 1.0f : 0.0f);
}

// The deferred sky's banks of one launch: (K, ph, pw) planes.
struct MissBanks {
  float* plane[6];  // thr_r, thr_g, thr_b, dir_x, dir_y, dir_z
  size_t stride;    // ph * pw
};

template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads) wavefront_paths_kernel(
    PathArgs a, SceneDims dims, int sky_kind, const float* __restrict__ corners,
    const float* __restrict__ fdata, const int* __restrict__ prog, float* __restrict__ out,
    MissBanks banks) {
  // the scene, the sky, the light table and the SH coefficients, once per
  // block in shared memory
  const SceneRef scene = stage_scene(prog, fdata, dims);
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= a.pw || ly >= a.ph) return;
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
  c.px = (uint32_t)(a.ox + lx);
  c.py = (uint32_t)(a.oy + ly);
  const Camera cam = load_camera(corners);
  const size_t pix = (size_t)ly * a.pw + lx;
  V3 acc = splat(0.0f);
  for (int k = 0; k < a.n_samples; ++k) {
    const uint32_t s = a.sample0 + (uint32_t)k;
    if (c.sky_kind == kSkyDefer) {
      // path slot k: channel ci of sample samp under dispersion
      const uint32_t samp = a.dispersion ? s / 3u : s;
      const uint32_t ci = s % 3u;
      const uint32_t sid = a.dispersion ? samp * 4u + ci + 1u : s;
      const V3 d0 = primary_ray(cam, a.seed, c.px, c.py, samp, a.width, a.height);
      const Path p =
          trace_path<kExact>(c, cam.eye, d0, sid, a.dispersion ? one_hot(ci) : splat(1.0f));
      const size_t slot = (size_t)k * banks.stride + pix;
      banks.plane[0][slot] = p.miss_thr.x;
      banks.plane[1][slot] = p.miss_thr.y;
      banks.plane[2][slot] = p.miss_thr.z;
      banks.plane[3][slot] = p.miss_dir.x;
      banks.plane[4][slot] = p.miss_dir.y;
      banks.plane[5][slot] = p.miss_dir.z;
      acc = add(acc, p.color);
    } else {
      const V3 d0 = primary_ray(cam, a.seed, c.px, c.py, s, a.width, a.height);
      V3 col;
      if (a.dispersion) {
        col = splat(0.0f);
        for (uint32_t ci = 0; ci < 3u; ++ci)
          col = add(col, trace_path<kExact>(c, cam.eye, d0, s * 4u + ci + 1u, one_hot(ci)).color);
      } else {
        col = trace_path<kExact>(c, cam.eye, d0, s, splat(1.0f)).color;
      }
      acc = add(acc, col);
    }
  }
  float* o = out + 3 * pix;
  o[0] = acc.x * a.inv_n;
  o[1] = acc.y * a.inv_n;
  o[2] = acc.z * a.inv_n;
}

}  // namespace

// Plain C entry point for ctypes.  `args` is a host pointer; the buffers
// are device pointers on CUDA device `device`; `out` is (ph, pw, 3)
// float32: the mean (times inv_n) over `n_samples` samples from `sample0`
// for a constant or SH sky; for an env image (`sky_kind` kSkyDefer) the
// raw sum over path slots 0 .. n_samples - 1 from path `sample0`, with
// `thr_r` .. `dir_z` each (K >= n_samples, ph, pw) float32, zero-filled by
// the caller.  `dims` (a host pointer) holds the sizes of the scene's
// buffers (scene_map.cuh SceneDims).  Returns the first CUDA error (0 on
// success), and cudaErrorInvalidValue for a scene whose tables exceed the
// block's shared memory or a deferred sky without banks.
extern "C" int rmr_wavefront_paths(const PathArgs* args, const SceneDims* dims, int sky_kind,
                                   const float* corners, const float* fdata, const int* prog,
                                   float* out, float* thr_r, float* thr_g, float* thr_b,
                                   float* dir_x, float* dir_y, float* dir_z, cudaStream_t stream,
                                   int device) {
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
  const dim3 block(16, kBlockThreads / 16);
  const dim3 grid((args->pw + block.x - 1) / block.x, (args->ph + block.y - 1) / block.y);
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  auto kernel = exact ? wavefront_paths_kernel<true> : wavefront_paths_kernel<false>;
  err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, bytes, stream>>>(*args, *dims, sky_kind, corners, fdata, prog, out, banks);
  return (int)cudaGetLastError();
}
