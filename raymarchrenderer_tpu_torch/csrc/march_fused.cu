// Per-ray sphere trace over planes of rays, for Hopper (sm_90a).
//
// Replaces the TPU kernel `march_fused` (raymarchrenderer_tpu/kernels/
// march.py:493, the pl.pallas_call at :575, whose body is
// render/integrator.py `march`).  Its plain PyTorch version is
// raymarchrenderer_tpu_torch/render/integrator.py `march` (classic) and
// `_march_relaxed`, and the wrapper is raymarchrenderer_tpu_torch/kernels/
// march.py `march_fused`.
//
// Each ray runs the plain version's loop step for step (march_ray.cuh,
// shared with the wavefront kernels and the wavefront recorder).  The Pallas kernel stops a tile when every ray of
// the tile is done; a done ray never changes again, so a ray that stops
// at its own done (or at max_steps) gives bitwise the same result.  The
// scene's objects are interpreted from the program of
// kernels/scene_program.py (`object_buffers`) through scene_map.cuh.
//
// Bound on the H100.  Bytes: 9 planes in (o, d, dist_mult, active, t_max)
// and 3 out (t, mid, hit), 48 bytes per ray: 0.06 ms for the 4 M rays of a
// 1024^2 x 4-sample plane at 3.35 TB/s.  Operations: every step of every
// live ray evaluates the object program (47 FP32 operations on
// sphere_on_floor) plus the step's own few, so at tens of steps per ray
// the operations bind (PERF.md holds the measured counts and times).  The
// card runs it far above that bound: divergent, interpreted map
// evaluations, and a warp that lives as long as its longest ray.
//
// Design.  The launch is a queue of rays, as the RGB lane machine's
// pixel queue (scene_map.cuh) but over rays: a persistent grid of as many
// blocks as stay resident, each staging the scene once, and every lane
// taking the next ray when its ray is done (one warp-aggregated atomicAdd
// per asking warp, on a counter the wrapper zeroes for every launch;
// rays in the planes' row-major order), so a warp no longer idles behind
// its longest ray.  That pays on the train step's later planes, whose
// rays vary most (bounce rays and the shadow-style planes); on a primary
// plane, whose warps already run 93% full, the queue's visits cost about
// what they save (PERF.md).  A lane visits the queue every
// `kMarchUnroll` steps.  Each lane writes its ray's three outputs, one
// writer per slot, so the outputs are the same bytes as one thread per
// ray.  The launch bound `kMinBlocksMarch` (scene_map.cuh) and
// `kMarchUnroll` were read by `chip_smoke.py --sweep-min-blocks` and
// `--sweep-const`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "march_ray.cuh"

using namespace rmr;

// Scalars of one launch; the ctypes structure in kernels/march.py mirrors
// this field for field (n, then the MarchParams fields).
struct MarchArgs {
  int n;
  MarchParams m;
};

// the march steps a lane takes between two visits to the queue
constexpr int kMarchUnroll = 4;

__global__ void __launch_bounds__(kBlockThreads, kMinBlocksMarch) march_fused_kernel(
    MarchArgs a, SceneDims dims, const int* __restrict__ prog, const float* __restrict__ fdata,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ dist_mult, const int* __restrict__ active,
    const float* __restrict__ t_max, float* __restrict__ t_out, int* __restrict__ mid_out,
    int* __restrict__ hit_out, int* __restrict__ queue) {
  // the object program, once per block in shared memory
  const SceneRef s = stage_scene(prog, fdata, dims);
  MarchState m;
  int i = 0;
  bool live = false, drained = false;
  for (;;) {
    const bool ask = !live && !drained;
    const int q = take_slot(queue, ask);
    if (ask) {
      if (q >= a.n) {
        drained = true;
      } else {
        i = q;
        march_begin(m, a.m, mk(ox[i], oy[i], oz[i]), mk(dx[i], dy[i], dz[i]), dist_mult[i],
                    t_max[i], active[i] != 0);
        live = true;
      }
    }
    if (__all_sync(0xffffffffu, drained && !live)) break;
    if (!live) continue;
    for (int u = 0; u < kMarchUnroll; ++u) {
      if (march_live(m, a.m)) march_advance(s, a.m, m);
    }
    if (!march_live(m, a.m)) {
      int mid;
      bool hit;
      t_out[i] = march_result(m, mid, hit);
      mid_out[i] = mid;
      hit_out[i] = hit ? 1 : 0;
      live = false;
    }
  }
}

// Plain C entry point for ctypes.  `args` and `dims` (the sizes of the
// scene's buffers, scene_map.cuh SceneDims) are host pointers; every other
// pointer is a device pointer on CUDA device `device`: the object program
// and its parameters, nine input planes of args->n lanes (o, d, dist_mult,
// active as int32, t_max), three outputs (t float32, mid and hit int32)
// and the ray queue's counter (one int32, zero before the launch).
// Returns the first CUDA error (0 on success).
extern "C" int rmr_march_fused(const MarchArgs* args, const SceneDims* dims, const int* prog,
                               const float* fdata,
                               const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const float* dist_mult, const int* active, const float* t_max,
                               float* t, int* mid, int* hit, int* queue, cudaStream_t stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args->n <= 0) return (int)cudaSuccess;
  int grid = 0;
  const size_t bytes = scene_smem_bytes(*dims, false);
  err = allow_smem(march_fused_kernel, bytes);
  if (err == cudaSuccess) {
    err = persistent_grid(march_fused_kernel, bytes, device, args->n, grid);
  }
  if (err != cudaSuccess) return (int)err;
  march_fused_kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, prog, fdata, ox, oy, oz,
                                                             dx, dy, dz, dist_mult, active, t_max,
                                                             t, mid, hit, queue);
  return (int)cudaGetLastError();
}
