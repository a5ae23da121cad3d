// Shared device code of the megakernels (mega_spectral.cu, mega_paths.cu):
// vec3 math, the counter-based RNG, the scene's object interpreter
// (map_dist, map_mid, get_normal) and uniform sphere sampling.
//
// The object program layout is written by kernels/scene_program.py, and
// the two must agree:
//
//   int32:   [n_objects, tail_int_offset, tail_float_offset, 0]    header
//            [first_word, n_nodes, distance_reg, mat_index] * n_objects
//            [opcode, out_reg, in0, in1, in2, in3] * nodes
//            ... each kernel's own tail at tail_int_offset
//   float32: object parameters (vec3 each), each kernel's own tail at
//            tail_float_offset
//
// An input word is a register (>= 0), the sample point (-1), or a vec3 at
// float offset `-word - 2`.  Every op follows the plain PyTorch version
// (scene/nodes.py, core/*.py) in order; the kernels are built with
// --fmad=false and without fast math, so each multiply and add rounds on
// its own as there.
#pragma once

#include <stdint.h>

namespace rmr {

// object program layout
constexpr int kMaxRegs = 16;
constexpr int kHeader = 4;
constexpr int kObjWords = 4;
constexpr int kNodeWords = 6;

enum Op {
  OP_SPHERE = 0, OP_BOX, OP_PLANE, OP_TORUS, OP_CYLINDER, OP_CAPSULE,
  OP_UNION, OP_SUBTRACT, OP_INTERSECT, OP_SMOOTH_UNION, OP_REPEAT,
  OP_GETX, OP_GETY, OP_GETZ, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SIN, OP_COS
};

constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0x85EBCA6Bu;
constexpr uint32_t kW2 = 0xC2B2AE35u;
constexpr uint32_t kW3 = 0x27D4EB2Fu;

// Launch shape of both megakernels: blocks of 16 x 8 threads, and at least
// six of them resident per SM (`__launch_bounds__`), which caps a thread's
// registers at 80.  The kernels are latency-bound by divergent, interpreted
// map evaluations, so resident warps pay; six keeps the spectral kernel at
// the occupancy it had before it shared this header (PERF.md).
constexpr int kBlockThreads = 128;
constexpr int kMinBlocks = 6;

constexpr float kTwoPi = 6.28318530717958647692f;  // f32(2 * pi), as 2.0 * _PI rounds
constexpr float kPi = 3.14159265358979323846f;

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
__device__ __forceinline__ bool is_zero(V3 a) { return a.x == 0.0f && a.y == 0.0f && a.z == 0.0f; }
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

// RNGStream(seed, px, py, f1, f2): the folded base, the pixel stage s1,
// the cached stage 2 and the draw counter
struct Rng {
  uint32_t s1, base, s2, ctr;
};

__device__ __forceinline__ Rng rng_make(uint32_t seed, uint32_t px, uint32_t py, uint32_t f1,
                                        uint32_t f2) {
  Rng r;
  r.base = avalanche(avalanche(seed * kW2 + f1 * kW3) + f2 * kW3);
  r.s1 = avalanche(px * kW0 + py * kW1);
  r.s2 = avalanche(r.s1 + r.base * kW2);
  r.ctr = 0;
  return r;
}

// RNGStream.fork(tag)
__device__ __forceinline__ Rng rng_fork(const Rng& p, uint32_t tag) {
  Rng r;
  r.base = avalanche(p.base + tag * kW1);
  r.s1 = p.s1;
  r.s2 = avalanche(r.s1 + r.base * kW2);
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
__device__ float map_dist(const SceneRef& s, float max_dist, V3 p) {
  const int n_obj = s.prog[0];
  if (n_obj == 0) return max_dist;
  float d = eval_object(s, 0, p);
  for (int i = 1; i < n_obj; ++i) d = fminf(d, eval_object(s, i, p));
  return d;
}

// material index at p: seeded with max_dist / -1, strict < take
__device__ int map_mid(const SceneRef& s, float max_dist, V3 p) {
  const int n_obj = s.prog[0];
  float d = max_dist;
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

// SDF-gradient normal: 4 tetrahedron taps or 6 central differences
__device__ V3 get_normal(const SceneRef& s, float max_dist, float e, int taps, V3 p) {
  if (taps == 4) {
    const float k[4][3] = {{1.0f, -1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f},
                           {-1.0f, 1.0f, -1.0f}, {1.0f, 1.0f, 1.0f}};
    V3 n = splat(0.0f);
    for (int i = 0; i < 4; ++i) {
      V3 kk = mk(k[i][0], k[i][1], k[i][2]);
      float d = map_dist(s, max_dist, add(p, scale(kk, e)));
      n = add(n, scale(kk, d));
    }
    return normalized(n);
  }
  V3 n = mk(map_dist(s, max_dist, mk(p.x + e, p.y, p.z)) -
                map_dist(s, max_dist, mk(p.x - e, p.y, p.z)),
            map_dist(s, max_dist, mk(p.x, p.y + e, p.z)) -
                map_dist(s, max_dist, mk(p.x, p.y - e, p.z)),
            map_dist(s, max_dist, mk(p.x, p.y, p.z + e)) -
                map_dist(s, max_dist, mk(p.x, p.y, p.z - e)));
  return normalized(n);
}

// ---- sampling (core/sampling.py) -------------------------------------------

__device__ __forceinline__ V3 uniform_sphere(float u1, float u2) {
  const float theta = kTwoPi * u1;
  const float cos_phi = 2.0f * u2 - 1.0f;
  const float sin_phi = sqrtf(fmaxf(1.0f - cos_phi * cos_phi, 0.0f));
  return mk(sin_phi * cosf(theta), cos_phi, sin_phi * sinf(theta));
}

// randHemisphere with the zero-normal pass-through
__device__ V3 uniform_sphere_or_hemisphere(float u1, float u2, V3 n) {
  const V3 b = uniform_sphere(u1, u2);
  const V3 bh = b.z < 0.0f ? neg(b) : b;
  // make_onb: n x (0,1,0), n x (0,0,1) written out as in the plain version
  const V3 c1 = mk(n.y * 0.0f - n.z * 1.0f, n.z * 0.0f - n.x * 0.0f, n.x * 1.0f - n.y * 0.0f);
  const V3 c2 = mk(n.y * 1.0f - n.z * 0.0f, n.z * 0.0f - n.x * 1.0f, n.x * 0.0f - n.y * 0.0f);
  const V3 x = normalized(select(dot(c1, c1) < 1e-12f, c2, c1));
  const V3 y = normalized(cross(n, x));
  const V3 rotated = add(add(scale(x, bh.x), scale(y, bh.y)), scale(n, bh.z));
  return is_zero(n) ? b : rotated;
}

__device__ __forceinline__ V3 corner(const float* f, int k) {
  return mk(f[3 * k], f[3 * k + 1], f[3 * k + 2]);
}

// The camera of one launch: the eye and the four corner rays.
struct Camera {
  V3 eye, r00, r10, r01, r11;
};

__device__ __forceinline__ Camera load_camera(const float* corners) {
  Camera c;
  c.eye = corner(corners, 0);
  c.r00 = corner(corners, 1);
  c.r10 = corner(corners, 2);
  c.r01 = corner(corners, 3);
  c.r11 = corner(corners, 4);
  return c;
}

// jittered primary ray of `sample` (render/raygen.py primary_rays)
__device__ V3 primary_ray(const Camera& cam, uint32_t seed, uint32_t px, uint32_t py,
                          uint32_t sample, int width, int height) {
  Rng rng = rng_make(seed, px, py, sample, 1u << 20);
  const float ux = rng_next(rng);
  const float uy = rng_next(rng);
  const float fx = ((float)(int)px + ux) / (float)width;
  const float fy = ((float)(int)py + uy) / (float)height;
  const V3 top = add(scale(cam.r00, 1.0f - fx), scale(cam.r10, fx));
  const V3 bot = add(scale(cam.r01, 1.0f - fx), scale(cam.r11, fx));
  return normalized(add(scale(top, 1.0f - fy), scale(bot, fy)));
}

}  // namespace rmr
