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

// One ray's march in flight: the segment (o, d, dist_mult, t_max) and the
// loop's carries.  `march_ray` runs it to its end; a lane machine (the RGB
// wavefront kernel) interleaves its steps with other work.
struct MarchState {
  V3 o, d;
  float dm, tmax, t, omega, prev_r, step_len;
  int mid, step;
  bool hit, done;
};

__device__ __forceinline__ void march_begin(MarchState& m, const MarchParams& a, V3 o, V3 d,
                                            float dm, float tmax, bool active) {
  m.o = o;
  m.d = d;
  m.dm = dm;
  m.tmax = tmax;
  m.t = 0.0f;
  m.mid = -1;
  m.hit = false;
  m.done = !active;
  m.omega = a.relax_omega;
  m.prev_r = 0.0f;
  m.step_len = 0.0f;
  m.step = 0;
}

// whether the march takes another step (the loop's condition)
__device__ __forceinline__ bool march_live(const MarchState& m, const MarchParams& a) {
  return m.step < a.max_steps && !m.done;
}

// one step of the loop
__device__ __forceinline__ void march_advance(const SceneRef& s, const MarchParams& a,
                                              MarchState& m) {
  int mm;
  const float dist = map_with_mid(s, a.max_dist, add(m.o, scale(m.d, m.t)), mm) * m.dm;
  if (a.relax) {
    const bool fail = m.omega > 1.0f && dist + m.prev_r < m.step_len;
    const bool is_hit = !fail && dist < a.hit_eps;
    const bool is_miss = !fail && !is_hit && m.t >= m.tmax;
    if (is_hit) {
      m.mid = mm;
      m.hit = true;
    }
    m.done = is_hit || is_miss;
    const float new_len = fail ? m.step_len * (1.0f - m.omega) : dist * m.omega;
    if (fail) m.omega = 1.0f;
    if (!m.done) {
      m.prev_r = fabsf(dist);
      m.step_len = fabsf(new_len);
      m.t = m.t + new_len;
    }
  } else {
    const bool is_hit = dist < a.hit_eps;
    const bool is_miss = m.t >= m.tmax && !is_hit;
    if (is_hit) {
      m.mid = mm;
      m.hit = true;
    }
    m.done = is_hit || is_miss;
    if (!m.done) m.t = m.t + dist * a.step_multiply;
  }
  m.step += 1;
}

// the march's result: t (t_max on a miss), and the material index (-1 on a
// miss) and the verdict through `mid_out` and `hit_out`
__device__ __forceinline__ float march_result(const MarchState& m, int& mid_out, bool& hit_out) {
  mid_out = m.hit ? m.mid : -1;
  hit_out = m.hit;
  return m.hit ? m.t : m.tmax;
}

// (t, material index, hit) of the ray o + t d: returns t, and the index
// and the verdict through `mid_out` and `hit_out`.
__device__ __forceinline__ float march_ray(const SceneRef& s, const MarchParams& a, V3 o, V3 d,
                                           float dm, float tmax, bool active, int& mid_out,
                                           bool& hit_out) {
  MarchState m;
  march_begin(m, a, o, d, dm, tmax, active);
  while (march_live(m, a)) march_advance(s, a, m);
  return march_result(m, mid_out, hit_out);
}

}  // namespace rmr
