// Shared device code of the RGB kernels (mega_paths.cu, wavefront_paths.cu):
// the launch scalars `PathArgs`, the material interpreter `eval_material`
// (scene/nodes.py, scene/graph.py `_eval_material`), a shadow ray toward a
// light (`light_ray`) and the skies the kernels evaluate in-kernel: the SH
// sky (`sh_eval`, core/sh.py) and the polynomial atan2 of the deferred
// sky's (u, v) pack (`atan2_poly`, core/vecmath.py).
//
// The material program layout is written by kernels/scene_program.py, and
// the two must agree.  Every op follows the plain PyTorch version in order
// (the kernels are built with --fmad=false and without fast math).
#pragma once

#include "march_ray.cuh"

namespace rmr {

// material program layout (kernels/scene_program.py must agree)
constexpr int kMaxMatRegs = 32;
constexpr int kMatWords = 7;    // first word, n_instr, rng_base, color, dir, inside, hit
constexpr int kInstrWords = 12;  // opcode, 4 outputs, 7 inputs

enum MatOp {
  M_DIFFUSE = 0, M_GLOSSY, M_REFRACTION, M_VOLUME, M_EMISSION, M_MIX, M_FACING, M_INSIDE,
  M_FRESNEL, M_ADD, M_SUB, M_MUL, M_DIV, M_SIN, M_COS, M_DIFFUSE2, M_GLOSSY2, M_MIX2
};

// the sky of a launch (kernels/scene_program.py SKY_*), an argument of the
// entry points beside PathArgs: one more field in PathArgs moved the
// megakernel's register allocation (spills 56 / 68 -> 188 / 184 bytes)
constexpr int kSkyConst = 0;  // vec3(env.power), the tail's first float
constexpr int kSkySh = 1;     // l <= 3 SH, 48 floats after the light table
constexpr int kSkyDefer = 2;  // an env image: misses banked, composited outside
constexpr int kShFloats = 48;

// Scalars of one launch; the ctypes structure in kernels/march.py mirrors
// this field for field.
struct PathArgs {
  int width, height;            // full frame (the raygen divisor)
  int ox, oy, pw, ph;           // patch origin and shape
  uint32_t sample0, seed;
  int n_samples, max_steps, max_bounces;
  int march_unroll, regen_cadence, lazy_miss, relax, normal_taps;
  int dispersion, nee, n_lights, rr_start_bounce;
  float max_dist, hit_eps, step_multiply, relax_omega, one_minus_omega;
  float omega0, normal_eps, surface_offset, exit_offset, inside_offset;
  float rr_min_prob, inv_n;
};

// The RGB tail floats of the staged scene: the sky power, the light table
// [pos * 3L, power * L, radius * L] of the scene's L lights, then the SH
// sky's (16, 3) coefficients (an SH sky only).
__device__ __forceinline__ float sky_power(const SceneRef& s) { return s.f()[s.prog()[2]]; }
__device__ __forceinline__ const float* light_table(const SceneRef& s) {
  return s.f() + s.prog()[2] + 1;
}
__device__ __forceinline__ const float* sh_coeffs(const SceneRef& s) {
  return light_table(s) + 5 * s.prog()[s.prog()[1] + 1];
}

// ---- materials (scene/nodes.py, scene/graph.py _eval_material) -----------

struct ShadeIn {
  V3 origin, dir, hit, normal, channels;
  float t, inside;
};

struct ShadeOut {
  V3 color, dir, inside, hit;
};

// ShadeCtx.grayscale(c * channels)
__device__ __forceinline__ float grayscale(V3 c, V3 ch) {
  return dot(c, ch) / (ch.x + ch.y + ch.z);
}

__device__ __forceinline__ V3 lerp3(V3 a, V3 b, float t) {
  return add(scale(a, 1.0f - t), scale(b, t));
}

__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return sub(d, scale(n, 2.0f * dot(d, n))); }

__device__ V3 refract(V3 d, V3 n, float eta) {
  const float cosi = -dot(d, n);
  float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const bool tir = k < 0.0f;
  k = fmaxf(k, 1e-12f);
  const V3 out = add(scale(d, eta), scale(n, eta * cosi - sqrtf(k)));
  return tir ? splat(0.0f) : out;
}

// normalized(v) * (dot(v, v) > 0)
__device__ __forceinline__ V3 unit_or_zero(V3 v) {
  return scale(normalized(v), dot(v, v) > 0.0f ? 1.0f : 0.0f);
}

// makeTBN applied to a y-up local sample
__device__ V3 tbn_apply(V3 n, V3 local) {
  // (0,1,0) x n written out as in the plain version
  const V3 crossed = mk(1.0f * n.z - 0.0f * n.y, 0.0f * n.x - 0.0f * n.z, 0.0f * n.y - 1.0f * n.x);
  const V3 tangent = n.x == 0.0f ? mk(1.0f, 0.0f, 0.0f) : normalized(crossed);
  const V3 bitangent = normalized(cross(tangent, n));
  return add(add(scale(bitangent, local.x), scale(n, local.y)), scale(tangent, local.z));
}

__device__ V3 cosine_hemisphere(float u1, float u2) {
  const float cos_t = sqrtf(fmaxf(1.0f - u1, 0.0f));
  const float sin_t = sqrtf(u1);
  const float o = u2 * 2.0f * kPi;
  return normalized(mk(sin_t * cosf(o), cos_t, sin_t * sinf(o)));
}

__device__ V3 ggx_lobe(float u1, float u2, float roughness) {
  const float a = roughness * roughness;
  const float o = u1 * 2.0f * kPi;
  const float denom = (a * a - 1.0f) * u2 + 1.0f;
  const float cos_t = sqrtf(fminf(fmaxf((1.0f - u2) / fmaxf(denom, 1e-12f), 1e-12f), 1.0f));
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
  return normalized(mk(sin_t * cosf(o), cos_t, sin_t * sinf(o)));
}

// The hit's material graph; all zeros for a miss of every object (mid -1).
__device__ ShadeOut eval_material(const SceneRef& s, int mid, const ShadeIn& in, Rng& rng) {
  const V3 zero = splat(0.0f);
  ShadeOut out;
  out.color = out.dir = out.inside = out.hit = zero;
  const int* tail = s.prog() + s.prog()[1];
  if (mid < 0 || mid >= tail[0]) return out;
  const int* md = tail + 2 + kMatWords * mid;
  rng.ctr = (uint32_t)md[2];
  V3 regs[kMaxMatRegs];
  for (int r = 0; r < kMaxMatRegs; ++r) regs[r] = zero;
  for (int k = 0; k < md[1]; ++k) {
    const int* w = s.prog() + md[0] + kInstrWords * k;
    const int* ins = w + 5;
    auto arg = [&](int j) -> V3 {
      const int code = ins[j];
      if (code >= 0) return regs[code];
      if (code == -1) return zero;
      const float* q = s.f() + (-code - 2);
      return mk(q[0], q[1], q[2]);
    };
    V3 o[4] = {zero, zero, zero, zero};
    switch (w[0]) {
      case M_DIFFUSE: {
        const float u1 = rng_next(rng);
        const float u2 = rng_next(rng);
        o[0] = arg(0);
        o[1] = uniform_sphere_or_hemisphere(u1, u2, in.normal);
        break;
      }
      case M_GLOSSY: {
        const float u1 = rng_next(rng);
        const float u2 = rng_next(rng);
        const V3 hemi = uniform_sphere_or_hemisphere(u1, u2, in.normal);
        const V3 n_f = scale(in.normal, -(in.inside * 2.0f - 1.0f));
        const V3 mirror = reflect(in.dir, n_f);
        const float wgt = 1.0f - grayscale(arg(1), in.channels);
        o[0] = arg(0);
        o[1] = lerp3(hemi, mirror, wgt);
        break;
      }
      case M_REFRACTION: {
        const float gs_ior = grayscale(arg(1), in.channels);
        const V3 enter_dir = unit_or_zero(refract(in.dir, in.normal, 1.0f / gs_ior));
        const V3 r_dir = unit_or_zero(refract(in.dir, neg(in.normal), gs_ior));
        const float u1 = rng_next(rng);
        const float u2 = rng_next(rng);
        const V3 d_dir = uniform_sphere_or_hemisphere(u1, u2, in.normal);
        const V3 exit_dir = lerp3(d_dir, r_dir, 1.0f - grayscale(arg(2), in.channels));
        const bool is_in = in.inside > 0.5f;
        o[0] = is_in ? arg(0) : splat(1.0f);
        o[1] = is_in ? exit_dir : enter_dir;
        o[2] = splat(1.0f - in.inside);
        break;
      }
      case M_VOLUME: {
        const bool is_in = in.inside > 0.5f;
        const float den = grayscale(arg(1), in.channels) / 20.0f;
        const float num_points = floorf(in.t * 100.0f);
        const float p_scatter = 1.0f - powf(fmaxf(1.0f - den, 0.0f), num_points);
        const float u_evt = rng_next(rng);
        const float u_pos = rng_next(rng);
        const bool scatters = is_in && u_evt < p_scatter;
        const V3 hit_pos = add(in.origin, scale(in.dir, u_pos * in.t));
        const float u3 = rng_next(rng);
        const float u4 = rng_next(rng);
        const V3 scat_dir = uniform_sphere_or_hemisphere(u3, u4, zero);
        const float inside_f = scatters ? 1.0f : (is_in ? 0.0f : 1.0f);
        o[0] = scatters ? arg(0) : splat(1.0f);
        o[1] = scatters ? scat_dir : in.dir;
        o[2] = splat(inside_f);
        o[3] = scatters ? hit_pos : zero;
        break;
      }
      case M_EMISSION:
        o[0] = scale(arg(0), grayscale(arg(1), in.channels));
        break;
      case M_MIX: {
        const float f = clamp01(grayscale(arg(6), in.channels));
        const bool take2 = rng_next(rng) < f;
        o[0] = take2 ? arg(3) : arg(0);
        o[1] = take2 ? arg(4) : arg(1);
        o[2] = take2 ? arg(5) : arg(2);
        break;
      }
      case M_FACING: {
        const float sgn = in.inside * 2.0f - 1.0f;
        o[0] = splat(clamp01(dot(scale(in.dir, sgn), in.normal)));
        break;
      }
      case M_INSIDE:
        o[0] = splat(in.inside);
        break;
      case M_FRESNEL: {
        const float c = clamp01(dot(in.normal, neg(in.dir)));
        o[0] = splat(powf(1.0f - c, 5.0f) * 0.96f + 0.04f);
        break;
      }
      case M_ADD:
        o[0] = add(arg(0), arg(1));
        break;
      case M_SUB:
        o[0] = sub(arg(0), arg(1));
        break;
      case M_MUL:
        o[0] = mul(arg(0), arg(1));
        break;
      case M_DIV: {
        const V3 a = arg(0), b = arg(1);
        o[0] = mk(a.x / b.x, a.y / b.y, a.z / b.z);
        break;
      }
      case M_SIN: {
        const V3 a = arg(0);
        o[0] = mk(sinf(a.x), sinf(a.y), sinf(a.z));
        break;
      }
      case M_COS: {
        const V3 a = arg(0);
        o[0] = mk(cosf(a.x), cosf(a.y), cosf(a.z));
        break;
      }
      case M_DIFFUSE2: {
        const float u1 = rng_next(rng);
        const float u2 = rng_next(rng);
        o[0] = arg(0);
        o[1] = tbn_apply(in.normal, cosine_hemisphere(u1, u2));
        break;
      }
      case M_GLOSSY2: {
        const float r = grayscale(arg(1), in.channels);
        const float u1 = rng_next(rng);
        const float u2 = rng_next(rng);
        const V3 rough_dir = tbn_apply(in.normal, ggx_lobe(u1, u2, r));
        o[0] = arg(0);
        o[1] = r == 0.0f ? reflect(in.dir, in.normal) : rough_dir;
        break;
      }
      default: {  // M_MIX2: bundles at registers ins[0] and ins[1], r <= f takes b
        const float f = clamp01(grayscale(arg(2), in.channels));
        const bool take_b = rng_next(rng) <= f;
        const int src = take_b ? ins[1] : ins[0];
        for (int j = 0; j < 4; ++j) o[j] = regs[src + j];
        break;
      }
    }
    for (int j = 0; j < 4; ++j)
      if (w[1 + j] >= 0) regs[w[1 + j]] = o[j];
  }
  // the color, dir, inside and hit bindings; an unbound one reads zero
  out.color = md[3] >= 0 ? regs[md[3]] : zero;
  out.dir = md[4] >= 0 ? regs[md[4]] : zero;
  out.inside = md[5] >= 0 ? regs[md[5]] : zero;
  out.hit = md[6] >= 0 ? regs[md[6]] : zero;
  return out;
}

// The ray from p toward a jittered point of light li of the table `lights`
// ([pos * 3n, power * n, radius * n]) on the NEE stream `nee_rng`, as
// light_segment draws it: returns its length and the unit direction
// through `ldir`.  (light_segment keeps its own copy: built on this
// helper, the recording kernel's spill loads rose from 72 to 88 bytes.)
__device__ __forceinline__ float light_ray(const float* lights, int n, int li, const Rng& nee_rng,
                                           V3 p, V3& ldir) {
  Rng lrng = rng_fork(nee_rng, 101u + (uint32_t)li);
  const V3 lpos = mk(lights[3 * li], lights[3 * li + 1], lights[3 * li + 2]);
  const float lradius = lights[4 * n + li];
  const float u1 = rng_next(lrng);
  const float u2 = rng_next(lrng);
  const V3 target = add(lpos, scale(uniform_sphere(u1, u2), lradius));
  const V3 delta = sub(target, p);
  const float dist_l = length(delta);
  const float dd = fmaxf(dist_l, 1e-8f);
  ldir = mk(delta.x / dd, delta.y / dd, delta.z / dd);
  return dist_l;
}

// The SH sky at unit direction d (core/sh.py `sh_eval`): the 16 basis terms
// with the same float32 constants, summed in the order k = 0..15 per
// channel, clamped at 0.  `c` holds the (16, 3) coefficients k-major.
__device__ V3 sh_eval(const float* c, V3 d) {
  const float x = d.x, y = d.y, z = d.z;
  const float b[16] = {
      0.282095f * 1.0f,
      0.488603f * y,
      0.488603f * z,
      0.488603f * x,
      1.092548f * x * y,
      1.092548f * y * z,
      0.315392f * (3.0f * z * z - 1.0f),
      1.092548f * x * z,
      0.546274f * (x * x - y * y),
      0.590044f * y * (3.0f * x * x - y * y),
      2.890611f * x * y * z,
      0.457046f * y * (5.0f * z * z - 1.0f),
      0.373176f * z * (5.0f * z * z - 3.0f),
      0.457046f * x * (5.0f * z * z - 1.0f),
      1.445306f * z * (x * x - y * y),
      0.590044f * x * (x * x - 3.0f * y * y)};
  float r = 0.0f, g = 0.0f, bl = 0.0f;
  for (int k = 0; k < 16; ++k) {
    r = r + b[k] * c[3 * k];
    g = g + b[k] * c[3 * k + 1];
    bl = bl + b[k] * c[3 * k + 2];
  }
  return mk(fmaxf(r, 0.0f), fmaxf(g, 0.0f), fmaxf(bl, 0.0f));
}

// Polynomial atan2 (core/vecmath.py `atan2_poly`), op for op: an odd
// minimax polynomial of atan on [0, 1] and quadrant folding.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float pi = 3.14159265358979f;
  const float half_pi = 1.5707963267949f;
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float r = lo / fmaxf(hi, 1e-30f);
  const float s = r * r;
  float a = (((((-0.0117212f * s + 0.05265332f) * s - 0.11643287f) * s + 0.19354346f) * s -
              0.33262347f) * s + 0.99997726f) * r;
  if (ay > ax) a = half_pi - a;
  if (x < 0.0f) a = pi - a;
  return y < 0.0f ? -a : a;
}

}  // namespace rmr
