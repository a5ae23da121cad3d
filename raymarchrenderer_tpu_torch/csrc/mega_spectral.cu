// Gen-3 spectral megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `render_fused_spectral` (raymarchrenderer_tpu/
// kernels/march.py, the pl.pallas_call with body render/mega.py
// `trace_mega_spectral`).  Its plain PyTorch version is
// raymarchrenderer_tpu_torch/render/mega.py `trace_mega_spectral`, and the
// wrapper is raymarchrenderer_tpu_torch/kernels/march.py.
//
// Design.  Each lane runs one pixel's own copy of the lane-state machine
// until its state reaches EXH (the render: one thread per pixel of the
// patch; the recorder: a persistent grid on the pixel queue): the peeled
// first march step, then bodies of `march_unroll` steps with a miss pass
// every `regen_cadence` steps, the lazy miss test at each pass boundary on
// the lane's own global step count, and one shade + regen pass per body.
// That reproduces the Pallas tile loop lane for lane, because an EXH lane
// is inert in every pass and every decision is keyed on the lane's own
// (px, py, sample, bounce) counter-based RNG stream.  With `lazy_miss`,
// where the pass boundaries fall decides which rare lanes overshoot
// max_dist, so the peeled step and the pass schedule are semantics, not
// scheduling.
//
// The scene is data: the wrapper compiles each object's node list into an
// int32 program (kernels/scene_program.py) and its parameters into a
// float32 buffer, with the band table as this kernel's tail; each block
// stages both in shared memory and `scene_map.cuh` interprets them,
// shared with the RGB kernel mega_paths.cu.
// All 20 object node types are covered.
//
// Bound on the H100: FP32 issue and warp divergence (neighbouring pixels
// take paths of different lengths), not bytes: a launch reads a few hundred
// bytes of scene and writes 12 bytes per pixel.  This first version is kept
// simple and exact: no FMA contraction (built with --fmad=false, no fast
// math), 1/sqrtf for normalisation, a divide by 5 in the band filter, and
// an interpreted scene.  Contraction and per-scene specialisation are left
// for later work.
//
// The recording entry `rmr_record_spectral` replaces the TPU kernel
// `trace_record_fused_spectral` (raymarchrenderer_tpu/kernels/record.py:434,
// the pl.pallas_call at :513, whose body is trace_mega_spectral with
// record_banks).  Its plain version is render/mega.py
// `trace_mega_spectral(record_banks=True)` and its wrapper
// kernels/record.py `trace_record_fused_spectral`.  It runs the same lane
// machine, instantiated with `Banks` instead of `NoBanks` (a template
// argument, so the render kernel compiles to the code it had without
// banks): a shaded hit writes (t, material, 1) to slot
// bounce * n_samples + sample of the (B * S, ph, pw) banks, each slot of a
// pixel with one writer, so no atomics.  The banked geometry does not
// depend on the band values (uniform hemisphere bounces, and a recording
// path ends only on an emitter hit or a miss, never on an absorption), so
// a recording lane skips the band filter, the power and the splat; it
// still steps the draw counter past the filter's draw, because the
// bounce direction is draws 2 and 3 of the stream.  The wrapper fills the
// banks with the miss values first.  Bound: 12 bytes per (bounce, sample)
// slot and pixel, written once (201 MB = 0.06 ms at 3.35 TB/s at the
// train launch, 1024^2 pixels x 4 samples x 4 bounces); the operations
// (the map evaluations the plain version's `work` counts) bind: 0.24 ms.
// It is latency-bound like the render, and more: a launch of 4 samples
// ends each pixel's chain early, so with one thread per pixel a warp
// lived as long as its longest of 32 short chains (chain occupancy 0.51
// at the train launch, 13.5 ms).  So the recorder runs a persistent grid:
// only as many blocks as stay resident, each lane taking the patch's
// pixels one after another from the pixel queue of scene_map.cuh (0.82
// modelled, 10.4-10.9 ms; PERF.md, NVIDIA H100 80GB HBM3, 700 W).  A
// pixel's chain still runs in one thread, op for op, and each bank slot
// has one writer, so the banks are the same bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spectral.cuh"

using namespace rmr;

namespace {

// The spectral lane machine's launch bound: at least twelve blocks of 128
// threads resident per SM, which caps a thread's registers at 40.  Its
// lane state is smaller than the RGB one's (scene_map.cuh kMinBlocks, 8),
// and the kMinBlocks sweep put its render fastest at 12; the recorder on
// its persistent grid was fastest at 12 too, of 6, 8, 10, 12 and 16
// (PERF.md).
constexpr int kMinBlocksSpectral = 12;

// lane states, as in render/mega.py
constexpr int kMarch = 0;
constexpr int kWait = 1;
constexpr int kRegen = 2;
constexpr int kExh = 7;
constexpr int kWaitMiss = -1;

// The lane machine's policies: `kOn` turns on the recording (banks of
// march residuals, no band filter, no image); `kExact` the exact normal
// (ExactNormal<policy>, normal_taps = 0); `kQueue` a persistent grid on
// the pixel queue (scene_map.cuh) instead of one thread per pixel.  Each
// is a template argument, so every instantiation compiles only its own
// code.

// The render: no banks, one thread per pixel.
struct NoBanks {
  static constexpr bool kOn = false;
  static constexpr bool kExact = false;
  static constexpr bool kQueue = false;
};

// The record banks of one recording launch, at this lane's pixel; the
// recorder's chains vary more than the render's (a launch of 4 samples,
// against 128), so its lanes take their pixels from the queue.
struct Banks {
  static constexpr bool kOn = true;
  static constexpr bool kExact = false;
  static constexpr bool kQueue = true;
  float* t;
  int* mid;
  int* hit;
  size_t plane;  // ph * pw
  size_t pix;    // the lane's pixel in the patch
};

}  // namespace

// ---- the lane-state machine (render/mega.py trace_mega_spectral) ----------

struct Lane {
  V3 o, d, acc;
  float t, wl, power, omega, prev_r, step_len;
  int bounce, s_idx, state, steps, gstep;
};

struct Ctx {
  SpecArgs a;
  SceneRef s;
  uint32_t px, py;
  Camera cam;
};

__device__ V3 primary(const Ctx& c, int s_idx) {
  return primary_ray(c.cam, c.a.seed, c.px, c.py, c.a.sample0 + (uint32_t)s_idx, c.a.width,
                     c.a.height);
}

__device__ void march_step(const Ctx& c, Lane& L) {
  const SpecArgs& a = c.a;
  if (a.lazy_miss) {
    L.gstep += 1;
  } else {
    L.steps += 1;  // unconditional, as in the plain version
  }
  if (L.state != kMarch) return;
  const V3 p = add(L.o, scale(L.d, L.t));
  const float dist = map_dist(c.s, a.max_dist, p);
  const bool fail = a.relax && L.omega > 1.0f && (dist + L.prev_r < L.step_len);
  const bool hit = !fail && dist < a.hit_eps;
  const bool miss =
      !a.lazy_miss && !fail && !hit && (L.t >= a.max_dist || L.steps >= a.max_steps);
  if (hit) L.state = kWait;
  if (miss) L.state = kWaitMiss;
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

__device__ __forceinline__ void mark_misses(const Ctx& c, Lane& L) {
  if (L.state == kMarch && (L.t >= c.a.max_dist || L.gstep - L.steps >= c.a.max_steps))
    L.state = kWaitMiss;
}

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
__device__ void regen(const Ctx& c, Lane& L) {
  if (L.state != kRegen) return;
  if constexpr (!R::kOn) L.acc = add(L.acc, scale(wavelength_to_rgb(L.wl), L.power));
  L.s_idx += 1;
  if (L.s_idx >= c.a.n_samples) {
    L.state = kExh;
    return;
  }
  L.state = kMarch;
  L.o = c.cam.eye;
  L.d = primary(c, L.s_idx);
  L.wl = 0.0f;
  L.power = 1.0f;
  L.bounce = 0;
  reset_segment(c, L);
}

template <class R>
__device__ void shade(const Ctx& c, Lane& L, const R& r) {
  if (L.state != kWait && L.state != kWaitMiss) return;
  const SpecArgs& a = c.a;
  const bool hit = L.state == kWait;
  Rng rng = rng_make(a.seed, c.px, c.py, a.sample0 + (uint32_t)L.s_idx, (uint32_t)L.bounce);
  // draw 1 is the band filter's; a recording skips the filter but keeps
  // the bounce direction on draws 2 and 3
  float u = 0.0f;
  if constexpr (R::kOn) {
    rng.ctr = 1u;
  } else {
    u = rng_next(rng);
  }
  float mn = 390.0f, mx = 830.0f, pw = a.sky_power;
  int kind = 0;
  V3 hitp = L.o, normal = splat(0.0f);
  if (hit) {
    hitp = add(L.o, scale(L.d, L.t));
    int mid = map_mid(c.s, a.max_dist, hitp);
    if constexpr (R::kOn) {
      const size_t k = (size_t)(L.bounce * a.n_samples + L.s_idx) * r.plane + r.pix;
      r.t[k] = L.t;
      r.mid[k] = mid;
      r.hit[k] = 1;
    }
    normal = get_normal<R::kExact>(c.s, a.max_dist, a.normal_eps, a.normal_taps, hitp);
    // the band table tail: ints [n_mats, kind * n_mats], floats
    // [min_wave * n_mats, max_wave * n_mats, power * n_mats]
    const int* tail = c.s.prog() + c.s.prog()[1];
    const int n_mats = tail[0];
    mid = mid < 0 ? 0 : (mid > n_mats - 1 ? n_mats - 1 : mid);
    const float* band = c.s.f() + c.s.prog()[2];
    mn = band[mid];
    mx = band[n_mats + mid];
    pw = band[2 * n_mats + mid];
    kind = tail[1 + mid];
  }
  // a recording path continues through an absorption: the soft band
  // filter of the replay attenuates instead
  bool absorbed = false;
  if constexpr (!R::kOn) absorbed = apply_band(L.wl, L.power, u, mn, mx, pw);
  const bool term = !hit || kind == 1 || absorbed;
  L.bounce += 1;
  const bool done = term || L.bounce >= a.max_bounces;
  L.state = done ? kRegen : kMarch;
  if (!done) {
    // a finished path's next ray is never read: regen replaces it below
    const float u1 = rng_next(rng);
    const float u2 = rng_next(rng);
    L.d = uniform_sphere_or_hemisphere(u1, u2, normal);
    L.o = add(hitp, scale(normal, a.surface_offset));
  }
  reset_segment(c, L);
}

template <class R>
__device__ void miss_pass(const Ctx& c, Lane& L) {
  if (L.state == kWaitMiss) {
    if constexpr (!R::kOn) {
      Rng rng = rng_make(c.a.seed, c.px, c.py, c.a.sample0 + (uint32_t)L.s_idx,
                         (uint32_t)L.bounce);
      const float u = rng_next(rng);
      apply_band(L.wl, L.power, u, 390.0f, 830.0f, c.a.sky_power);
    }
    L.bounce += 1;
    L.state = kRegen;
  }
  regen<R>(c, L);
}

template <class R>
__device__ void body(const Ctx& c, Lane& L, const R& r) {
  const SpecArgs& a = c.a;
  if (a.regen_cadence > 0 && a.regen_cadence < a.march_unroll) {
    const int n_sub = a.march_unroll / a.regen_cadence;
    for (int sub = 0; sub < n_sub; ++sub) {
      for (int k = 0; k < a.regen_cadence; ++k) march_step(c, L);
      if (sub < n_sub - 1) {
        if (a.lazy_miss) mark_misses(c, L);
        miss_pass<R>(c, L);
      }
    }
  } else {
    for (int k = 0; k < a.march_unroll; ++k) march_step(c, L);
  }
  if (a.lazy_miss) mark_misses(c, L);
  shade(c, L, r);
  regen<R>(c, L);
}

// A lane's start on the pixel (c.px, c.py): sample 0's primary ray and
// the peeled first march step.  Then `body` runs until the state reaches
// EXH, and L.acc holds the sum over n_samples of the splat (a recording
// lane's stays zero: it leaves its banks).
__device__ void start_lane(const Ctx& c, Lane& L) {
  L.o = c.cam.eye;
  L.d = primary(c, 0);
  L.acc = splat(0.0f);
  L.t = 0.0f;
  L.wl = 0.0f;
  L.power = 1.0f;
  L.omega = c.a.omega0;
  L.prev_r = 0.0f;
  L.step_len = 0.0f;
  L.bounce = 0;
  L.s_idx = 0;
  L.state = kMarch;
  L.steps = 0;
  L.gstep = 0;
  march_step(c, L);  // the peeled first step
}

// ---- launch ----------------------------------------------------------------

// R = NoBanks, or ExactNormal<NoBanks> for normal_taps = 0
template <class R>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksSpectral)
    mega_spectral_kernel(SpecArgs a, SceneDims dims, const float* __restrict__ corners,
                         const float* __restrict__ fdata, const int* __restrict__ prog,
                         float* __restrict__ out) {
  // the scene and its band table, once per block in shared memory
  const SceneRef s = stage_scene(prog, fdata, dims);
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= a.pw || ly >= a.ph) return;
  Ctx c;
  c.a = a;
  c.s = s;
  c.px = (uint32_t)(a.ox + lx);
  c.py = (uint32_t)(a.oy + ly);
  c.cam = load_camera(corners);
  Lane L;
  start_lane(c, L);
  while (L.state < kExh) body(c, L, R());
  float* o = out + 3 * ((size_t)ly * a.pw + lx);
  o[0] = L.acc.x * a.inv_n;
  o[1] = L.acc.y * a.inv_n;
  o[2] = L.acc.z * a.inv_n;
}

// Plain C entry point for ctypes.  `args` and `dims` (the sizes of the
// scene's buffers, scene_map.cuh SceneDims) are host pointers; the buffers
// are device pointers on CUDA device `device`; `out` is (ph, pw, 3)
// float32.  The library carries its own (static) CUDA runtime, so it
// selects the device itself before launching on `stream`.  Returns the
// first CUDA error (0 on success).
extern "C" int rmr_mega_spectral(const SpecArgs* args, const SceneDims* dims, const float* corners,
                                 const float* fdata, const int* prog, float* out,
                                 cudaStream_t stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(16, kBlockThreads / 16);
  const dim3 grid((args->pw + block.x - 1) / block.x, (args->ph + block.y - 1) / block.y);
  const bool exact = args->normal_taps == 0;
  const size_t bytes = scene_smem_bytes(*dims, exact);
  auto kernel = exact ? mega_spectral_kernel<ExactNormal<NoBanks>> : mega_spectral_kernel<NoBanks>;
  err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, bytes, stream>>>(*args, *dims, corners, fdata, prog, out);
  return (int)cudaGetLastError();
}

// The recording kernel: the same lane machine with banks (R = Banks, or
// ExactNormal<Banks> for normal_taps = 0) on a persistent grid: each lane
// runs one pixel's whole chain at a time, as a thread of a
// one-pixel-per-thread launch would, and takes the next pixel from the
// queue when its chain reaches EXH.
template <class R>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocksSpectral)
    record_spectral_kernel(SpecArgs a, SceneDims dims, const float* __restrict__ corners,
                           const float* __restrict__ fdata, const int* __restrict__ prog,
                           R banks, int* __restrict__ queue) {
  static_assert(R::kQueue, "the recorder runs on the pixel queue");
  const SceneRef s = stage_scene(prog, fdata, dims);
  Ctx c;
  c.a = a;
  c.s = s;
  c.cam = load_camera(corners);
  const int n_slots = queue_len(a.pw, a.ph);
  Lane L;
  bool live = false, drained = false;
  for (;;) {
    const bool ask = !live && !drained;
    const int q = take_slot(queue, ask);
    if (ask) {
      int lx, ly;
      if (q >= n_slots) {
        drained = true;
      } else if (queue_pixel(a.pw, a.ph, q, lx, ly)) {
        c.px = (uint32_t)(a.ox + lx);
        c.py = (uint32_t)(a.oy + ly);
        banks.pix = (size_t)ly * a.pw + lx;
        start_lane(c, L);
        live = true;
      }
    }
    if (__all_sync(0xffffffffu, drained && !live)) break;
    if (!live) continue;
    body(c, L, banks);
    if (L.state >= kExh) live = false;
  }
}

// Launch the recording kernel of policy R with the scene's shared memory
// on a persistent grid fed by the zeroed counter `queue`; returns the CUDA
// error.
template <class R>
cudaError_t launch_record(const SpecArgs* args, const SceneDims* dims, const float* corners,
                          const float* fdata, const int* prog, const R& banks, int* queue,
                          cudaStream_t stream, int device) {
  const size_t bytes = scene_smem_bytes(*dims, R::kExact);
  const int n_slots = queue_len(args->pw, args->ph);
  int grid = 0;
  auto kernel = record_spectral_kernel<R>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) err = persistent_grid(kernel, bytes, device, n_slots, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, corners, fdata, prog, banks, queue);
  return cudaGetLastError();
}

// The recording entry: as rmr_mega_spectral, but the lanes bank their
// march residuals into `t` (float32), `mid` and `hit` (int32), each
// (max_bounces * n_samples, ph, pw), slot bounce * n_samples + sample; the
// caller fills them with the miss values first.  No image is written.
// `queue` is one int32 on the device, zero before the launch (the pixel
// queue's counter).
extern "C" int rmr_record_spectral(const SpecArgs* args, const SceneDims* dims,
                                   const float* corners, const float* fdata, const int* prog,
                                   float* t, int* mid, int* hit, int* queue, cudaStream_t stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Banks banks;
  banks.t = t;
  banks.mid = mid;
  banks.hit = hit;
  banks.plane = (size_t)args->ph * args->pw;
  banks.pix = 0;
  if (args->normal_taps == 0) {
    return (int)launch_record(args, dims, corners, fdata, prog, ExactNormal<Banks>(banks), queue,
                              stream, device);
  }
  return (int)launch_record(args, dims, corners, fdata, prog, banks, queue, stream, device);
}
