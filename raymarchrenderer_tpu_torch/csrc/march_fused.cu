// Per-ray sphere trace over planes of rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel `march_fused` (raymarchrenderer_tpu/kernels/
// march.py:493, the pl.pallas_call at :575, whose body is
// render/integrator.py `march`).  Its plain PyTorch version is
// raymarchrenderer_tpu_torch/render/integrator.py `march` (classic) and
// `_march_relaxed`, and the wrapper is raymarchrenderer_tpu_torch/kernels/
// march.py `march_fused`.
//
// Design.  One thread per ray, any number of rays (the sample-folded
// (S*H, W) planes of the train step go straight in, flattened); nothing is
// padded.  Each thread runs the plain version's loop step for step:
// map(o + t d) * dist_mult with the material index, the hit test on the
// pre-step t, the miss test t >= t_max, and in the relaxed loop the failed
// step's back-off by step_len * (1 - omega), with prev_r and step_len
// updated only on advancing lanes.  A miss, and the step budget running
// out, return t = t_max and material -1.  The Pallas kernel stops a tile
// when every ray of the tile is done; a done ray never changes again, so a
// thread that stops at its own done (or at max_steps) gives bitwise the
// same result.  The scene's objects are interpreted from the program of
// kernels/scene_program.py (`object_buffers`) through scene_map.cuh.
//
// Bound on the H100.  Bytes: 9 planes in (o, d, dist_mult, active, t_max)
// and 3 out (t, mid, hit), 48 bytes per ray: 0.06 ms for the 4 M rays of a
// 1024^2 x 4-sample plane at 3.35 TB/s.  Operations: every step of every
// live ray evaluates the object program (47 FP32 operations on
// sphere_on_floor) plus the step's own few, so at tens of steps per ray
// the operations bind (PERF.md holds the measured counts and times).  The
// kernel is latency-bound like the megakernels (divergent, interpreted map
// evaluations); this first version keeps them exact (--fmad=false) and
// simple.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scene_map.cuh"

using namespace rmr;

// Scalars of one launch; the ctypes structure in kernels/march.py mirrors
// this field for field.
struct MarchArgs {
  int n, max_steps, relax;
  float max_dist, hit_eps, step_multiply, relax_omega;
};

// The march's map (scene/graph.py `Scene.map`): the distance and material
// index, seeded with max_dist and -1, an object taken where strictly
// nearer.
__device__ __forceinline__ float map_with_mid(const SceneRef& s, float max_dist, V3 p, int& mid) {
  const int n_obj = s.prog[0];
  float d = max_dist;
  mid = -1;
  for (int i = 0; i < n_obj; ++i) {
    const float di = eval_object(s, i, p);
    if (di < d) {
      d = di;
      mid = s.prog[kHeader + kObjWords * i + 3];
    }
  }
  return d;
}

__global__ void __launch_bounds__(kBlockThreads) march_fused_kernel(
    MarchArgs a, const int* __restrict__ prog, const float* __restrict__ fdata,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ dist_mult, const int* __restrict__ active,
    const float* __restrict__ t_max, float* __restrict__ t_out, int* __restrict__ mid_out,
    int* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  SceneRef s;
  s.prog = prog;
  s.f = fdata;
  const V3 o = mk(ox[i], oy[i], oz[i]);
  const V3 d = mk(dx[i], dy[i], dz[i]);
  const float dm = dist_mult[i];
  const float tmax = t_max[i];
  float t = 0.0f;
  int mid = -1;
  bool hit = false;
  bool done = active[i] == 0;
  float omega = a.relax_omega;
  float prev_r = 0.0f;
  float step_len = 0.0f;
  for (int step = 0; step < a.max_steps && !done; ++step) {
    int m;
    const float dist = map_with_mid(s, a.max_dist, add(o, scale(d, t)), m) * dm;
    if (a.relax) {
      const bool fail = omega > 1.0f && dist + prev_r < step_len;
      const bool is_hit = !fail && dist < a.hit_eps;
      const bool is_miss = !fail && !is_hit && t >= tmax;
      if (is_hit) {
        mid = m;
        hit = true;
      }
      done = is_hit || is_miss;
      const float new_len = fail ? step_len * (1.0f - omega) : dist * omega;
      if (fail) omega = 1.0f;
      if (!done) {
        prev_r = fabsf(dist);
        step_len = fabsf(new_len);
        t = t + new_len;
      }
    } else {
      const bool is_hit = dist < a.hit_eps;
      const bool is_miss = t >= tmax && !is_hit;
      if (is_hit) {
        mid = m;
        hit = true;
      }
      done = is_hit || is_miss;
      if (!done) t = t + dist * a.step_multiply;
    }
  }
  t_out[i] = hit ? t : tmax;
  mid_out[i] = hit ? mid : -1;
  hit_out[i] = hit ? 1 : 0;
}

// Plain C entry point for ctypes.  `args` is a host pointer; every other
// pointer is a device pointer on CUDA device `device`: the object program
// and its parameters, nine input planes of args->n lanes (o, d, dist_mult,
// active as int32, t_max) and three outputs (t float32, mid and hit
// int32).  Returns the first CUDA error (0 on success).
extern "C" int rmr_march_fused(const MarchArgs* args, const int* prog, const float* fdata,
                               const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const float* dist_mult, const int* active, const float* t_max,
                               float* t, int* mid, int* hit, cudaStream_t stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args->n <= 0) return (int)cudaSuccess;
  const int grid = (args->n + kBlockThreads - 1) / kBlockThreads;
  march_fused_kernel<<<grid, kBlockThreads, 0, stream>>>(*args, prog, fdata, ox, oy, oz, dx, dy,
                                                         dz, dist_mult, active, t_max, t, mid, hit);
  return (int)cudaGetLastError();
}
