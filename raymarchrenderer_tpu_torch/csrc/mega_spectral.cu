// Gen-3 spectral megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `render_fused_spectral` (raymarchrenderer_tpu/
// kernels/march.py, the pl.pallas_call with body render/mega.py
// `trace_mega_spectral`).  Its plain PyTorch version is
// raymarchrenderer_tpu_torch/render/mega.py `trace_mega_spectral`, and the
// wrapper is raymarchrenderer_tpu_torch/kernels/march.py.
//
// Design.  One thread per pixel of the patch.  Each thread runs its own
// copy of the lane-state machine until its state reaches EXH: the peeled
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
// float32 buffer; `map_dist` and `map` interpret it.  All 20 object node
// types are covered.
//
// Bound on the H100: FP32 issue and warp divergence (neighbouring pixels
// take paths of different lengths), not bytes: a launch reads a few hundred
// bytes of scene and writes 12 bytes per pixel.  This first version is kept
// simple and exact: no FMA contraction (built with --fmad=false, no fast
// math), 1/sqrtf for normalisation, a divide by 5 in the band filter, and
// an interpreted scene.  Contraction and per-scene specialisation are left
// for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// lane states, as in render/mega.py
constexpr int kMarch = 0;
constexpr int kWait = 1;
constexpr int kRegen = 2;
constexpr int kExh = 7;
constexpr int kWaitMiss = -1;

// object program layout (kernels/scene_program.py must agree)
constexpr int kMaxRegs = 16;
constexpr int kHeader = 4;      // n_objects, n_mats, band float offset, kind int offset
constexpr int kObjWords = 4;    // first node word, n_nodes, distance register, material index
constexpr int kNodeWords = 6;   // opcode, output register, 4 inputs

enum Op {
  OP_SPHERE = 0, OP_BOX, OP_PLANE, OP_TORUS, OP_CYLINDER, OP_CAPSULE,
  OP_UNION, OP_SUBTRACT, OP_INTERSECT, OP_SMOOTH_UNION, OP_REPEAT,
  OP_GETX, OP_GETY, OP_GETZ, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SIN, OP_COS
};

constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0x85EBCA6Bu;
constexpr uint32_t kW2 = 0xC2B2AE35u;
constexpr uint32_t kW3 = 0x27D4EB2Fu;

}  // namespace

// Scalars of one launch; the ctypes structure in kernels/march.py mirrors
// this field for field.
struct SpecArgs {
  int width, height;            // full frame (the raygen divisor)
  int ox, oy, pw, ph;           // patch origin and shape
  uint32_t sample0, seed;
  int n_samples, max_steps, max_bounces;
  int march_unroll, regen_cadence, lazy_miss, relax, normal_taps;
  float max_dist, hit_eps, step_multiply, relax_omega, one_minus_omega;
  float omega0, normal_eps, surface_offset, sky_power, inv_n;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 splat(float s) { return mk(s, s, s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(fmaxf(dot(a, a), 1e-24f)); }
__device__ __forceinline__ V3 normalized(V3 a) {
  float inv = 1.0f / sqrtf(fmaxf(dot(a, a), 1e-24f));
  return scale(a, inv);
}
__device__ __forceinline__ V3 select(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// ---- counter-based RNG (core/rng.py) --------------------------------------

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

struct Rng {
  uint32_t s2;
  uint32_t ctr;
};

// RNGStream(seed, px, py, f1, f2) with its cached stage 2
__device__ __forceinline__ Rng rng_make(uint32_t seed, uint32_t px, uint32_t py, uint32_t f1,
                                        uint32_t f2) {
  uint32_t base = seed * kW2;
  base = avalanche(base + f1 * kW3);
  base = avalanche(base + f2 * kW3);
  uint32_t s1 = avalanche(px * kW0 + py * kW1);
  Rng r;
  r.s2 = avalanche(s1 + base * kW2);
  r.ctr = 0;
  return r;
}

__device__ __forceinline__ float rng_next(Rng& r) {
  r.ctr += 1;
  uint32_t bits = avalanche(r.s2 + r.ctr * kW3);
  return (float)(int)(bits >> 8) * (1.0f / 16777216.0f);
}

// ---- scene interpreter (scene/graph.py map / map_dist) ---------------------

struct SceneRef {
  const int* prog;
  const float* f;
};

__device__ __forceinline__ V3 fetch(const SceneRef& s, const V3* regs, V3 p, int code) {
  if (code >= 0) return regs[code];
  if (code == -1) return p;
  const float* q = s.f + (-code - 2);
  return mk(q[0], q[1], q[2]);
}

// python-style float modulo, as torch.remainder / jnp.mod
__device__ __forceinline__ float pymod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ float repeat_axis(float c, float period) {
  return period != 0.0f ? pymod(c, period) - period * 0.5f : c;
}

__device__ float eval_object(const SceneRef& s, int obj, V3 p) {
  const int* od = s.prog + kHeader + kObjWords * obj;
  const int first = od[0];
  const int n_nodes = od[1];
  V3 regs[kMaxRegs];
  for (int k = 0; k < n_nodes; ++k) {
    const int* nd = s.prog + first + kNodeWords * k;
    const V3 a = fetch(s, regs, p, nd[2]);
    const V3 b = fetch(s, regs, p, nd[3]);
    const V3 c = fetch(s, regs, p, nd[4]);
    const V3 e = fetch(s, regs, p, nd[5]);
    V3 out;
    switch (nd[0]) {
      case OP_SPHERE:
        out = splat(length(sub(a, b)) - c.x);
        break;
      case OP_BOX: {
        V3 q = sub(mk(fabsf(a.x - b.x), fabsf(a.y - b.y), fabsf(a.z - b.z)), c);
        float outside = length(mk(fmaxf(q.x, 0.0f), fmaxf(q.y, 0.0f), fmaxf(q.z, 0.0f)));
        float inside = fminf(fmaxf(q.x, fmaxf(q.y, q.z)), 0.0f);
        out = splat(inside + outside);
        break;
      }
      case OP_PLANE:
        out = splat(dot(a, normalized(b)) - c.x);
        break;
      case OP_TORUS: {
        V3 q = sub(a, b);
        float ql = sqrtf(q.x * q.x + q.z * q.z) - c.x;
        out = splat(sqrtf(ql * ql + q.y * q.y) - c.y);
        break;
      }
      case OP_CYLINDER: {
        V3 q = sub(a, b);
        float dxz = sqrtf(q.x * q.x + q.z * q.z) - c.x;
        float dy = fabsf(q.y) - c.y;
        float mx = fmaxf(dxz, 0.0f);
        float my = fmaxf(dy, 0.0f);
        out = splat(fminf(fmaxf(dxz, dy), 0.0f) + sqrtf(mx * mx + my * my));
        break;
      }
      case OP_CAPSULE: {
        V3 pa = sub(a, b);
        V3 ba = sub(c, b);
        float h = clamp01(dot(pa, ba) / fmaxf(dot(ba, ba), 1e-30f));
        out = splat(length(sub(pa, scale(ba, h))) - e.x);
        break;
      }
      case OP_UNION:
        out = mk(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z));
        break;
      case OP_SUBTRACT:
        out = mk(fmaxf(a.x, -b.x), fmaxf(a.y, -b.y), fmaxf(a.z, -b.z));
        break;
      case OP_INTERSECT:
        out = mk(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z));
        break;
      case OP_SMOOTH_UNION: {
        float h = clamp01(0.5f + 0.5f * (b.x - a.x) / c.x);
        out = splat((b.x * (1.0f - h) + a.x * h) - c.x * h * (1.0f - h));
        break;
      }
      case OP_REPEAT:
        out = mk(repeat_axis(a.x, b.x), repeat_axis(a.y, b.y), repeat_axis(a.z, b.z));
        break;
      case OP_GETX:
        out = splat(a.x);
        break;
      case OP_GETY:
        out = splat(a.y);
        break;
      case OP_GETZ:
        out = splat(a.z);
        break;
      case OP_ADD:
        out = add(a, b);
        break;
      case OP_SUB:
        out = sub(a, b);
        break;
      case OP_MUL:
        out = mul(a, b);
        break;
      case OP_DIV:
        out = mk(a.x / b.x, a.y / b.y, a.z / b.z);
        break;
      case OP_SIN:
        out = mk(sinf(a.x), sinf(a.y), sinf(a.z));
        break;
      default:  // OP_COS
        out = mk(cosf(a.x), cosf(a.y), cosf(a.z));
        break;
    }
    if (nd[1] >= 0) regs[nd[1]] = out;
  }
  return regs[od[2]].x;
}

// distance only: running fminf seeded from object 0
__device__ float map_dist(const SceneRef& s, const SpecArgs& a, V3 p) {
  const int n_obj = s.prog[0];
  if (n_obj == 0) return a.max_dist;
  float d = eval_object(s, 0, p);
  for (int i = 1; i < n_obj; ++i) d = fminf(d, eval_object(s, i, p));
  return d;
}

// material index at p: seeded with max_dist / -1, strict < take
__device__ int map_mid(const SceneRef& s, const SpecArgs& a, V3 p) {
  const int n_obj = s.prog[0];
  float d = a.max_dist;
  int mid = -1;
  for (int i = 0; i < n_obj; ++i) {
    float di = eval_object(s, i, p);
    if (di < d) {
      d = di;
      mid = s.prog[kHeader + kObjWords * i + 3];
    }
  }
  return mid;
}

__device__ V3 get_normal(const SceneRef& s, const SpecArgs& a, V3 p) {
  const float e = a.normal_eps;
  if (a.normal_taps == 4) {
    const float k[4][3] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f},
                           {-1.0f, 1.0f, -1.0f}, {1.0f, 1.0f, 1.0f}};
    V3 n = splat(0.0f);
    for (int i = 0; i < 4; ++i) {
      V3 kk = mk(k[i][0], k[i][1], k[i][2]);
      float d = map_dist(s, a, add(p, scale(kk, e)));
      n = add(n, scale(kk, d));
    }
    return normalized(n);
  }
  V3 n = mk(map_dist(s, a, mk(p.x + e, p.y, p.z)) - map_dist(s, a, mk(p.x - e, p.y, p.z)),
            map_dist(s, a, mk(p.x, p.y + e, p.z)) - map_dist(s, a, mk(p.x, p.y - e, p.z)),
            map_dist(s, a, mk(p.x, p.y, p.z + e)) - map_dist(s, a, mk(p.x, p.y, p.z - e)));
  return normalized(n);
}

// ---- transport pieces -----------------------------------------------------

// randHemisphere with the zero-normal pass-through (core/sampling.py)
__device__ V3 uniform_sphere_or_hemisphere(float u1, float u2, V3 n) {
  const float theta = 6.28318530717958647692f * u1;
  const float cos_phi = 2.0f * u2 - 1.0f;
  const float sin_phi = sqrtf(fmaxf(1.0f - cos_phi * cos_phi, 0.0f));
  const V3 b = mk(sin_phi * cosf(theta), cos_phi, sin_phi * sinf(theta));
  const bool zero_n = n.x == 0.0f && n.y == 0.0f && n.z == 0.0f;
  const V3 bh = b.z < 0.0f ? neg(b) : b;
  // make_onb: n x (0,1,0), n x (0,0,1) written out as in the plain version
  const V3 c1 = mk(n.y * 0.0f - n.z * 1.0f, n.z * 0.0f - n.x * 0.0f, n.x * 1.0f - n.y * 0.0f);
  const V3 c2 = mk(n.y * 1.0f - n.z * 0.0f, n.z * 0.0f - n.x * 1.0f, n.x * 0.0f - n.y * 0.0f);
  const V3 x = normalized(select(dot(c1, c1) < 1e-12f, c2, c1));
  const V3 y = normalized(cross(n, x));
  const V3 rotated = add(add(scale(x, bh.x), scale(y, bh.y)), scale(n, bh.z));
  return zero_n ? b : rotated;
}

// wavelengthToColor (core/spectral.py), same where-chain
__device__ V3 wavelength_to_rgb(float wl) {
  float r = (wl >= 380.0f && wl < 440.0f) ? -(wl - 440.0f) / 60.0f : 0.0f;
  if (wl >= 510.0f && wl < 580.0f) r = (wl - 510.0f) / 70.0f;
  if (wl >= 580.0f && wl < 645.0f) r = 1.0f;
  if (wl >= 645.0f && wl <= 780.0f) r = 1.0f;
  float g = (wl >= 440.0f && wl < 490.0f) ? (wl - 440.0f) / 50.0f : 0.0f;
  if (wl >= 490.0f && wl < 510.0f) g = 1.0f;
  if (wl >= 510.0f && wl < 580.0f) g = 1.0f;
  if (wl >= 580.0f && wl < 645.0f) g = -(wl - 645.0f) / 65.0f;
  float b = (wl >= 380.0f && wl < 440.0f) ? 1.0f : 0.0f;
  if (wl >= 440.0f && wl < 490.0f) b = 1.0f;
  if (wl >= 490.0f && wl < 510.0f) b = -(wl - 510.0f) / 20.0f;
  float alpha = (wl > 780.0f || wl < 380.0f) ? 0.0f : 1.0f;
  if (wl > 700.0f && wl <= 780.0f) alpha = (780.0f - wl) / 80.0f;
  if (wl < 420.0f && wl >= 380.0f) alpha = (wl - 380.0f) / 40.0f;
  return mk(r * alpha, g * alpha, b * alpha);
}

// one mat_func_N body (render/spectral_integrator.py _apply_band)
__device__ __forceinline__ bool apply_band(float& wl, float& power, float u, float mn, float mx,
                                           float p) {
  const float r = u * (mx - mn) / 5.0f;
  const float sampled = floorf(r) * 5.0f + mn;
  const bool unset = wl == 0.0f;
  const bool outside = wl < mn || wl > mx;
  if (unset || !outside) power = power * p;
  wl = unset ? sampled : (outside ? 0.0f : wl);
  return !unset && outside;
}

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
  V3 eye, r00, r10, r01, r11;
};

__device__ V3 primary(const Ctx& c, int s_idx) {
  Rng rng = rng_make(c.a.seed, c.px, c.py, c.a.sample0 + (uint32_t)s_idx, 1u << 20);
  const float ux = rng_next(rng);
  const float uy = rng_next(rng);
  const float fx = ((float)(int)c.px + ux) / (float)c.a.width;
  const float fy = ((float)(int)c.py + uy) / (float)c.a.height;
  const V3 top = add(scale(c.r00, 1.0f - fx), scale(c.r10, fx));
  const V3 bot = add(scale(c.r01, 1.0f - fx), scale(c.r11, fx));
  return normalized(add(scale(top, 1.0f - fy), scale(bot, fy)));
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
  const float dist = map_dist(c.s, a, p);
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

__device__ void regen(const Ctx& c, Lane& L) {
  if (L.state != kRegen) return;
  const V3 col = scale(wavelength_to_rgb(L.wl), L.power);
  L.acc = add(L.acc, col);
  L.s_idx += 1;
  if (L.s_idx >= c.a.n_samples) {
    L.state = kExh;
    return;
  }
  L.state = kMarch;
  L.o = c.eye;
  L.d = primary(c, L.s_idx);
  L.wl = 0.0f;
  L.power = 1.0f;
  L.bounce = 0;
  reset_segment(c, L);
}

__device__ void shade(const Ctx& c, Lane& L) {
  if (L.state != kWait && L.state != kWaitMiss) return;
  const SpecArgs& a = c.a;
  const bool hit = L.state == kWait;
  Rng rng = rng_make(a.seed, c.px, c.py, a.sample0 + (uint32_t)L.s_idx, (uint32_t)L.bounce);
  const float u = rng_next(rng);
  float mn = 390.0f, mx = 830.0f, pw = a.sky_power;
  int kind = 0;
  V3 hitp = L.o, normal = splat(0.0f);
  if (hit) {
    hitp = add(L.o, scale(L.d, L.t));
    int mid = map_mid(c.s, a, hitp);
    normal = get_normal(c.s, a, hitp);
    const int n_mats = c.s.prog[1];
    mid = mid < 0 ? 0 : (mid > n_mats - 1 ? n_mats - 1 : mid);
    const float* band = c.s.f + c.s.prog[2];
    mn = band[mid];
    mx = band[n_mats + mid];
    pw = band[2 * n_mats + mid];
    kind = c.s.prog[c.s.prog[3] + mid];
  }
  const bool absorbed = apply_band(L.wl, L.power, u, mn, mx, pw);
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

__device__ void miss_pass(const Ctx& c, Lane& L) {
  if (L.state == kWaitMiss) {
    Rng rng = rng_make(c.a.seed, c.px, c.py, c.a.sample0 + (uint32_t)L.s_idx,
                       (uint32_t)L.bounce);
    const float u = rng_next(rng);
    apply_band(L.wl, L.power, u, 390.0f, 830.0f, c.a.sky_power);
    L.bounce += 1;
    L.state = kRegen;
  }
  regen(c, L);
}

__device__ void body(const Ctx& c, Lane& L) {
  const SpecArgs& a = c.a;
  if (a.regen_cadence > 0 && a.regen_cadence < a.march_unroll) {
    const int n_sub = a.march_unroll / a.regen_cadence;
    for (int sub = 0; sub < n_sub; ++sub) {
      for (int k = 0; k < a.regen_cadence; ++k) march_step(c, L);
      if (sub < n_sub - 1) {
        if (a.lazy_miss) mark_misses(c, L);
        miss_pass(c, L);
      }
    }
  } else {
    for (int k = 0; k < a.march_unroll; ++k) march_step(c, L);
  }
  if (a.lazy_miss) mark_misses(c, L);
  shade(c, L);
  regen(c, L);
}

// The whole per-pixel program: the sum over n_samples of the splat.
__device__ V3 trace_pixel(const Ctx& c) {
  Lane L;
  L.o = c.eye;
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
  while (L.state < kExh) body(c, L);
  return L.acc;
}

__device__ __forceinline__ V3 corner(const float* f, int k) {
  return mk(f[3 * k], f[3 * k + 1], f[3 * k + 2]);
}

// ---- launch ----------------------------------------------------------------

__global__ void mega_spectral_kernel(SpecArgs a, const float* __restrict__ corners,
                                     const float* __restrict__ fdata,
                                     const int* __restrict__ prog, float* __restrict__ out) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  if (lx >= a.pw || ly >= a.ph) return;
  Ctx c;
  c.a = a;
  c.s.prog = prog;
  c.s.f = fdata;
  c.px = (uint32_t)(a.ox + lx);
  c.py = (uint32_t)(a.oy + ly);
  c.eye = corner(corners, 0);
  c.r00 = corner(corners, 1);
  c.r10 = corner(corners, 2);
  c.r01 = corner(corners, 3);
  c.r11 = corner(corners, 4);
  const V3 acc = trace_pixel(c);
  float* o = out + 3 * ((size_t)ly * a.pw + lx);
  o[0] = acc.x * a.inv_n;
  o[1] = acc.y * a.inv_n;
  o[2] = acc.z * a.inv_n;
}

// Plain C entry point for ctypes.  `args` is a host pointer; the buffers
// are device pointers on CUDA device `device`; `out` is (ph, pw, 3)
// float32.  The library carries its own (static) CUDA runtime, so it
// selects the device itself before launching on `stream`.  Returns the
// first CUDA error (0 on success).
extern "C" int rmr_mega_spectral(const SpecArgs* args, const float* corners, const float* fdata,
                                 const int* prog, float* out, cudaStream_t stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(16, 8);
  const dim3 grid((args->pw + block.x - 1) / block.x, (args->ph + block.y - 1) / block.y);
  mega_spectral_kernel<<<grid, block, 0, stream>>>(*args, corners, fdata, prog, out);
  return (int)cudaGetLastError();
}
