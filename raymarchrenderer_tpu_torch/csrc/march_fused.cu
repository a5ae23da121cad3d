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
// padded.  Each thread runs the plain version's loop step for step
// (`march_ray` in march_ray.cuh, shared with the wavefront recorder of
// mega_paths.cu).  The Pallas kernel stops a tile when every ray of the
// tile is done; a done ray never changes again, so a thread that stops at
// its own done (or at max_steps) gives bitwise the same result.  The
// scene's objects are interpreted from the program of
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

#include "march_ray.cuh"

using namespace rmr;

// Scalars of one launch; the ctypes structure in kernels/march.py mirrors
// this field for field (n, then the MarchParams fields).
struct MarchArgs {
  int n;
  MarchParams m;
};

__global__ void __launch_bounds__(kBlockThreads) march_fused_kernel(
    MarchArgs a, SceneDims dims, const int* __restrict__ prog, const float* __restrict__ fdata,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ dist_mult, const int* __restrict__ active,
    const float* __restrict__ t_max, float* __restrict__ t_out, int* __restrict__ mid_out,
    int* __restrict__ hit_out) {
  // the object program, once per block in shared memory
  const SceneRef s = stage_scene(prog, fdata, dims);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  int mid;
  bool hit;
  t_out[i] = march_ray(s, a.m, mk(ox[i], oy[i], oz[i]), mk(dx[i], dy[i], dz[i]), dist_mult[i],
                       t_max[i], active[i] != 0, mid, hit);
  mid_out[i] = mid;
  hit_out[i] = hit ? 1 : 0;
}

// Plain C entry point for ctypes.  `args` and `dims` (the sizes of the
// scene's buffers, scene_map.cuh SceneDims) are host pointers; every other
// pointer is a device pointer on CUDA device `device`: the object program
// and its parameters, nine input planes of args->n lanes (o, d, dist_mult,
// active as int32, t_max) and three outputs (t float32, mid and hit
// int32).  Returns the first CUDA error (0 on success).
extern "C" int rmr_march_fused(const MarchArgs* args, const SceneDims* dims, const int* prog,
                               const float* fdata,
                               const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const float* dist_mult, const int* active, const float* t_max,
                               float* t, int* mid, int* hit, cudaStream_t stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args->n <= 0) return (int)cudaSuccess;
  const int grid = (args->n + kBlockThreads - 1) / kBlockThreads;
  const size_t bytes = scene_smem_bytes(*dims, false);
  err = allow_smem(march_fused_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  march_fused_kernel<<<grid, kBlockThreads, bytes, stream>>>(*args, *dims, prog, fdata, ox, oy, oz,
                                                             dx, dy, dz, dist_mult, active, t_max,
                                                             t, mid, hit);
  return (int)cudaGetLastError();
}
