// The per-ray sphere trace (render/integrator.py `march` and
// `_march_relaxed`), shared by march_fused.cu and the wavefront recorder of
// mega_paths.cu.
//
// One call marches one ray the way the plain version marches one lane:
// map(o + t d) * dist_mult with the material index, the hit test on the
// pre-step t, the miss test t >= t_max, and in the relaxed loop the failed
// step's back-off by step_len * (1 - omega), with prev_r and step_len
// updated only on advancing steps.  A miss, an inactive ray and the step
// budget running out return t = t_max and material -1.  The plain version
// stops when every lane is done; a done lane never changes again, so one
// ray stopping at its own done gives the same result.
#pragma once

#include "scene_map.cuh"

namespace rmr {

// The march's scalars (a prefix of march_fused.cu's MarchArgs after `n`).
struct MarchParams {
  int max_steps, relax;
  float max_dist, hit_eps, step_multiply, relax_omega;
};

// The march's map (scene/graph.py `Scene.map`): the distance and material
// index, seeded with max_dist and -1, an object taken where strictly
// nearer.
__device__ __forceinline__ float map_with_mid(const SceneRef& s, float max_dist, V3 p, int& mid) {
  const int n_obj = s.prog()[0];
  float d = max_dist;
  mid = -1;
  for (int i = 0; i < n_obj; ++i) {
    const float di = eval_object(s, i, p);
    if (di < d) {
      d = di;
      mid = s.prog()[kHeader + kObjWords * i + 3];
    }
  }
  return d;
}

// (t, material index, hit) of the ray o + t d: returns t, and the index
// and the verdict through `mid_out` and `hit_out`.
__device__ __forceinline__ float march_ray(const SceneRef& s, const MarchParams& a, V3 o, V3 d,
                                           float dm, float tmax, bool active, int& mid_out,
                                           bool& hit_out) {
  float t = 0.0f;
  int mid = -1;
  bool hit = false;
  bool done = !active;
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
  mid_out = hit ? mid : -1;
  hit_out = hit;
  return hit ? t : tmax;
}

}  // namespace rmr
