// Shared device code of every kernel: vec3 math, the counter-based RNG,
// the scene's object interpreter (map_dist, map_mid, get_normal and its
// exact gradient grad_map), uniform sphere sampling, the staging of a
// scene into shared memory and the launch bounds.
//
// The object program layout is written by kernels/scene_program.py, and
// the two must agree:
//
//   int32:   [n_objects, tail_int_offset, tail_float_offset, n_regs]  header
//            [first_word, n_nodes, distance_word, mat_index] * n_objects
//            [opcode | marks, out_reg, in0, in1, in2, in3] * nodes
//            ... each kernel's own tail at tail_int_offset
//   float32: object parameters (vec3 each), each kernel's own tail at
//            tail_float_offset
//
// An input word is a register (>= 0), the sample point (-1), or a vec3 at
// float offset `-word - 2`.  Every node that writes has a register of its
// own (n_regs: the most one object writes).  The forwarding marks above
// the opcode (kFwdIn << k: input k is the previous node's value; kFwdOut:
// nothing but the next node or the distance reads this value) and above
// the distance register (kFwdDist: the distance is the last node's value)
// let the interpreter carry a value from one node to the next in
// registers: a one-node object touches no register slot at all.  Every op
// follows the plain PyTorch version (scene/nodes.py, core/*.py) in order;
// the kernels are built with --fmad=false and without fast math, so each
// multiply and add rounds on its own as there.
//
// Shared memory.  Each block stages the scene's program words and data
// floats (the tail included: lights, SH coefficients, band table,
// material parameters) in its dynamic shared memory once, so every read
// of them is a broadcast, and every thread's register slots follow them
// (`SceneDims`, `scene_smem_bytes`): the stored (unforwarded) node values,
// or, in an exact-normal instantiation, every node's value, its adjoint
// and its live bits.  The sizes come from the scene, so neither the node
// count nor the light count is capped by a constant; a scene whose tables
// exceed the block's shared memory is refused with its size by the
// wrappers.
#pragma once

#include <stddef.h>
#include <stdint.h>

namespace rmr {

// object program layout
constexpr int kHeader = 4;
constexpr int kObjWords = 4;
constexpr int kNodeWords = 6;
// the forwarding marks (kernels/scene_program.py FWD_*)
constexpr int kOpMask = 0xFF;
constexpr int kFwdIn = 1 << 8;
constexpr int kFwdOut = 1 << 12;
constexpr int kFwdDist = 1 << 16;
constexpr int kRegMask = 0xFFFF;

enum Op {
  OP_SPHERE = 0, OP_BOX, OP_PLANE, OP_TORUS, OP_CYLINDER, OP_CAPSULE,
  OP_UNION, OP_SUBTRACT, OP_INTERSECT, OP_SMOOTH_UNION, OP_REPEAT,
  OP_GETX, OP_GETY, OP_GETZ, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_SIN, OP_COS
};

constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0x85EBCA6Bu;
constexpr uint32_t kW2 = 0xC2B2AE35u;
constexpr uint32_t kW3 = 0x27D4EB2Fu;

// Launch shape of every kernel: blocks of 128 threads; the RGB lane
// machine asks for at least eight of them resident per SM
// (`__launch_bounds__`), which caps a thread's registers at 64 (the
// spectral one sets its own, mega_spectral.cu).  The kernels are
// latency-bound by divergent, interpreted map evaluations, so resident
// warps pay more than the spills they cost: re-read after the scene moved
// to shared memory, 8 beat 4, 5, 6, 10, 12 and 16 on the RGB render and
// recording launches (PERF.md, `chip_smoke.py --sweep-min-blocks`).
// `kMinBlocksMarch` is march_fused.cu's bound, `kMinBlocksWavefront` the
// RGB wavefront lane machine's (wavefront_paths.cu), read the same way.
constexpr int kBlockThreads = 128;
constexpr int kMinBlocks = 8;
constexpr int kMinBlocksMarch = 12;
constexpr int kMinBlocksWavefront = 8;

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

// The block's dynamic shared memory: the staged scene (`stage_scene`).
// Addressed through this symbol (never through a pointer kept in a
// register or passed to a call), so every read of it is a shared-memory
// load and a SceneRef holds two offsets.
extern __shared__ __align__(16) float rmr_smem[];

// A scene as the interpreter reads it, in rmr_smem: the program words from
// word 0, the data floats from word `fo`, and this thread's register
// slots: slot k's component j at word ro + (3 k + j) * kBlockThreads.
struct SceneRef {
  int fo, ro;
  __device__ __forceinline__ const int* prog() const {
    return reinterpret_cast<const int*>(rmr_smem);
  }
  __device__ __forceinline__ const float* f() const { return rmr_smem + fo; }
  __device__ __forceinline__ float* r() const { return rmr_smem + ro; }
};

// The sizes a launch stages (kernels/scene_program.py `_assemble`): the
// program words, the data floats, the stencil interpreter's register
// slots (stored values) and the registers of the exact normal's sweep.
struct SceneDims {
  int n_words, n_floats, n_stored, n_regs;
};

// The block's dynamic shared memory for a scene (scene_program.py
// `shared_bytes` must agree): the program and data, then per thread 3
// floats per stored slot, or with the exact normal 7 words per register
// (value, adjoint, live bits).
inline size_t scene_smem_bytes(const SceneDims& d, bool exact) {
  const size_t per_thread = exact ? 7 * (size_t)d.n_regs : 3 * (size_t)d.n_stored;
  return 4 * ((size_t)d.n_words + (size_t)d.n_floats + kBlockThreads * per_thread);
}

#ifdef __CUDACC__
// A kernel's launch with `bytes` of dynamic shared memory: above the
// default 48 KiB the kernel opts in first (cudaErrorInvalidValue beyond
// the device's limit).  Returns the CUDA error.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
#endif

// Copy the scene's program and data into the block's dynamic shared memory
// (every thread of the block takes part) and return the SceneRef of this
// thread.  Every launch runs blocks of kBlockThreads threads.
__device__ __forceinline__ SceneRef stage_scene(const int* __restrict__ prog,
                                                const float* __restrict__ fdata,
                                                const SceneDims& d) {
  int* sp = reinterpret_cast<int*>(rmr_smem);
  float* sf = rmr_smem + d.n_words;
  const int n_threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < d.n_words; i += n_threads) sp[i] = prog[i];
  for (int i = tid; i < d.n_floats; i += n_threads) sf[i] = fdata[i];
  __syncthreads();
  SceneRef s;
  s.fo = d.n_words;
  s.ro = d.n_words + d.n_floats + tid;
  return s;
}

__device__ __forceinline__ V3 reg_get(const SceneRef& s, int k) {
  const float* q = s.r() + 3 * k * kBlockThreads;
  return mk(q[0], q[kBlockThreads], q[2 * kBlockThreads]);
}
__device__ __forceinline__ void reg_put(const SceneRef& s, int k, V3 v) {
  float* q = s.r() + 3 * k * kBlockThreads;
  q[0] = v.x;
  q[kBlockThreads] = v.y;
  q[2 * kBlockThreads] = v.z;
}

// input `code` of a node: the previous node's value when forwarded, else a
// register slot, the point or a parameter
__device__ __forceinline__ V3 fetch(const SceneRef& s, V3 p, V3 prev, int code, int fwd) {
  if (fwd) return prev;
  if (code >= 0) return reg_get(s, code);
  if (code == -1) return p;
  const float* q = s.f() + (-code - 2);
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

// The value of one object node (opcode `op`) on its inputs.
__device__ __forceinline__ V3 node_value(int op, V3 a, V3 b, V3 c, V3 e) {
  V3 out;
  switch (op) {
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
  return out;
}

// Run object `obj`'s nodes at p; returns its distance.  The stencil
// interpreter (kStoreAll false) stores only the values the marks do not
// forward; the exact normal's reverse sweep (kStoreAll) stores every
// node's value in its register slot.
template <bool kStoreAll>
__device__ __forceinline__ float run_object(const SceneRef& s, int obj, V3 p) {
  const int* od = s.prog() + kHeader + kObjWords * obj;
  const int first = od[0];
  const int n_nodes = od[1];
  V3 prev = p;
  for (int k = 0; k < n_nodes; ++k) {
    const int* nd = s.prog() + first + kNodeWords * k;
    const int w = nd[0];
    const V3 a = fetch(s, p, prev, nd[2], w & kFwdIn);
    const V3 b = fetch(s, p, prev, nd[3], w & (kFwdIn << 1));
    const V3 c = fetch(s, p, prev, nd[4], w & (kFwdIn << 2));
    const V3 e = fetch(s, p, prev, nd[5], w & (kFwdIn << 3));
    prev = node_value(w & kOpMask, a, b, c, e);
    if (nd[1] >= 0 && (kStoreAll || !(w & kFwdOut))) reg_put(s, nd[1], prev);
  }
  return (od[2] & kFwdDist) ? prev.x : reg_get(s, od[2] & kRegMask).x;
}

__device__ __forceinline__ float eval_object(const SceneRef& s, int obj, V3 p) {
  return run_object<false>(s, obj, p);
}

// distance only: running fminf seeded from object 0
__device__ float map_dist(const SceneRef& s, float max_dist, V3 p) {
  const int n_obj = s.prog()[0];
  if (n_obj == 0) return max_dist;
  float d = eval_object(s, 0, p);
  for (int i = 1; i < n_obj; ++i) d = fminf(d, eval_object(s, i, p));
  return d;
}

// material index at p: seeded with max_dist / -1, strict < take
__device__ int map_mid(const SceneRef& s, float max_dist, V3 p) {
  const int n_obj = s.prog()[0];
  float d = max_dist;
  int mid = -1;
  for (int i = 0; i < n_obj; ++i) {
    float di = eval_object(s, i, p);
    if (di < d) {
      d = di;
      mid = s.prog()[kHeader + kObjWords * i + 3];
    }
  }
  return mid;
}

// ---- the exact gradient (normal_taps = 0) ----------------------------------
//
// grad_map is the reverse sweep of map_dist at p: the plain version is
// torch.autograd of scene.map_dist (render/integrator.py exact_gradient,
// with core/sdf.py's JAX derivatives at the kinks), and each node's
// adjoint below repeats torch's backward formula op for op (sqrt:
// g / (2 sqrt x); a / b: g / b and -g ((a / b) / b); x * x: g x + g x;
// min / max: a tie splits 0.5 / 0.5, the loser gets 0, as JAX's for any
// finite cotangent).  The clamps of core/sdf.py's jclamp take JAX's rule:
// a tie with the bound splits 0.5 / 0.5 and the cotangent passes by a
// multiply (balanced_eq); jabs' (0) = 1.  No multiply by a zero cotangent
// is skipped: inf * 0 is NaN where JAX's is (inside a cylinder,
// sqrt'(0) = inf).  A register
// component no later node reads has no cotangent at all (its `live` bit
// stays clear), as an unused value has none in torch or JAX; the object
// compiler gives every node its own register, so the forward's registers
// hold every node's inputs when the reverse pass reads them.

// JAX's balanced_eq(x, ans, y): 1 where x is the result, halved where y
// is too
__device__ __forceinline__ float bal(float x, float ans, float y) {
  return (x == ans ? 1.0f : 0.0f) / (y == ans ? 2.0f : 1.0f);
}

// Vec3.length = sqrt(clamp(dot(q, q), min=1e-24)): q's adjoint from g
__device__ __forceinline__ V3 length_adj(float g, V3 q) {
  const float ss = dot(q, q);
  const float l = sqrtf(fmaxf(ss, 1e-24f));
  const float gs = ss >= 1e-24f ? g / (2.0f * l) : 0.0f;
  const float tx = gs * q.x, ty = gs * q.y, tz = gs * q.z;
  return mk(tx + tx, ty + ty, tz + tz);
}

// torch.maximum / torch.minimum's adjoint of input x against the other
// input y: a tie splits, the losing input gets 0
__device__ __forceinline__ float ext_adj(float g, float x, float y, bool take_max) {
  if (x == y) return g / 2.0f;
  return (take_max ? x < y : x > y) ? 0.0f : g;
}

// jclamp(x, lo, 1) of core/sdf.py: jnp.clip's adjoint, the minimum first
__device__ __forceinline__ float clip_adj(float g, float x, float lo, float hi) {
  const float m = fmaxf(x, lo);
  return (g * bal(m, fminf(m, hi), hi)) * bal(x, m, lo);
}

// torch's floor division of floats (the divisor's adjoint of remainder)
__device__ __forceinline__ float floor_div(float a, float b) {
  const float m = fmodf(a, b);
  float d = (a - m) / b;
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) d -= 1.0f;
  if (d == 0.0f) return copysignf(0.0f, a / b);
  float f = floorf(d);
  if (d - f > 0.5f) f += 1.0f;
  return f;
}

__device__ __forceinline__ float& comp(V3& v, int k) { return (&v.x)[k]; }
__device__ __forceinline__ float at(const V3& v, int k) { return (&v.x)[k]; }

// The adjoint registers of one object, in this thread's shared-memory
// slots after the n_regs value registers: register k's adjoint component j
// at v[(3 k + j) * kBlockThreads] and its live bits (one per component) at
// live[k * kBlockThreads]; and the point's adjoint.
struct Adj {
  float* v;
  int* live;
  V3 dp;
};

__device__ __forceinline__ Adj adj_file(const SceneRef& s) {
  const int n_regs = s.prog()[3];
  Adj A;
  A.v = s.r() + 3 * n_regs * kBlockThreads;
  A.live = reinterpret_cast<int*>(s.r() + 6 * n_regs * kBlockThreads);
  A.dp = splat(0.0f);
  return A;
}

// add `val` to component k of input `code`'s adjoint (constants have none)
__device__ __forceinline__ void acc(Adj& A, int code, int k, float val) {
  if (code >= 0) {
    float& slot = A.v[(3 * code + k) * kBlockThreads];
    int& lv = A.live[code * kBlockThreads];
    const int bit = 1 << k;
    slot = (lv & bit) ? slot + val : val;
    lv |= bit;
  } else if (code == -1) {
    comp(A.dp, k) = comp(A.dp, k) + val;
  }
}
__device__ __forceinline__ void acc3(Adj& A, int code, V3 val) {
  acc(A, code, 0, val.x);
  acc(A, code, 1, val.y);
  acc(A, code, 2, val.z);
}

// a node's input in the reverse sweep, where every node's value is stored
__device__ __forceinline__ V3 fetch_stored(const SceneRef& s, V3 p, int code) {
  return fetch(s, p, p, code, 0);
}

// The reverse of one node: its inputs' adjoints from its output's.
__device__ void node_adjoint(const SceneRef& s, V3 p, const int* nd, Adj& A) {
  const int out = nd[1];
  if (out < 0) return;
  const int lm = A.live[out * kBlockThreads] & 7;
  if (lm == 0) return;  // nothing reads this node
  const float* gv = A.v + 3 * out * kBlockThreads;
  const V3 g = mk(gv[0], gv[kBlockThreads], gv[2 * kBlockThreads]);
  // a splat node's scalar adjoint: the sum of its read components
  float gs = 0.0f;
  bool first = true;
  for (int k = 0; k < 3; ++k) {
    if (lm & (1 << k)) {
      gs = first ? at(g, k) : gs + at(g, k);
      first = false;
    }
  }
  const int ia = nd[2], ib = nd[3], ic = nd[4], ie = nd[5];
  const V3 a = fetch_stored(s, p, ia);
  const V3 b = fetch_stored(s, p, ib);
  const V3 c = fetch_stored(s, p, ic);
  const int op = nd[0] & kOpMask;
  switch (op) {
    case OP_SPHERE: {
      const V3 gq = length_adj(gs, sub(a, b));
      acc3(A, ia, gq);
      acc3(A, ib, neg(gq));
      acc(A, ic, 0, -gs);
      break;
    }
    case OP_BOX: {
      const V3 d = sub(a, b);
      const V3 q = sub(mk(fabsf(d.x), fabsf(d.y), fabsf(d.z)), c);
      const V3 m = mk(fmaxf(q.x, 0.0f), fmaxf(q.y, 0.0f), fmaxf(q.z, 0.0f));
      const V3 gm = length_adj(gs, m);
      const float in_yz = fmaxf(q.y, q.z);
      const float mq = fmaxf(q.x, in_yz);
      const float gmq = gs * bal(mq, fminf(mq, 0.0f), 0.0f);
      const float gyz = ext_adj(gmq, in_yz, q.x, true);
      // torch.clamp(q, min=0): where(q >= 0, g, 0)
      const V3 gq = mk((q.x >= 0.0f ? gm.x : 0.0f) + ext_adj(gmq, q.x, in_yz, true),
                       (q.y >= 0.0f ? gm.y : 0.0f) + ext_adj(gyz, q.y, q.z, true),
                       (q.z >= 0.0f ? gm.z : 0.0f) + ext_adj(gyz, q.z, q.y, true));
      const V3 gd = mk(d.x >= 0.0f ? gq.x : -gq.x, d.y >= 0.0f ? gq.y : -gq.y,
                       d.z >= 0.0f ? gq.z : -gq.z);
      acc3(A, ia, gd);
      acc3(A, ib, neg(gd));
      acc3(A, ic, neg(gq));
      break;
    }
    case OP_PLANE: {
      const float inv = 1.0f / sqrtf(fmaxf(dot(b, b), 1e-24f));
      const V3 n = scale(b, inv);
      acc3(A, ia, scale(n, gs));
      if (ib > -2) {
        // n = b * inv, inv = reciprocal(sqrt(clamp(dot(b, b), 1e-24)))
        const V3 gn = scale(a, gs);
        const float ginv = (gn.x * b.x + gn.y * b.y) + gn.z * b.z;
        const float ss = dot(b, b);
        const float r = sqrtf(fmaxf(ss, 1e-24f));
        const float gr = -ginv * (inv * inv);
        const float gss = ss >= 1e-24f ? gr / (2.0f * r) : 0.0f;
        const float tx = gss * b.x, ty = gss * b.y, tz = gss * b.z;
        acc3(A, ib, mk(gn.x * inv + (tx + tx), gn.y * inv + (ty + ty), gn.z * inv + (tz + tz)));
      }
      acc(A, ic, 0, -gs);
      break;
    }
    case OP_TORUS: {
      const V3 q = sub(a, b);
      const float r1 = sqrtf(q.x * q.x + q.z * q.z);
      const float ql = r1 - c.x;
      const float r2 = sqrtf(ql * ql + q.y * q.y);
      const float g2 = gs / (2.0f * r2);
      const float u = g2 * ql, v = g2 * q.y;
      const float gql = u + u;
      const float g1 = gql / (2.0f * r1);
      const float w = g1 * q.x, z = g1 * q.z;
      const V3 gq = mk(w + w, v + v, z + z);
      acc3(A, ia, gq);
      acc3(A, ib, neg(gq));
      acc(A, ic, 0, -gql);
      acc(A, ic, 1, -gs);
      break;
    }
    case OP_CYLINDER: {
      const V3 q = sub(a, b);
      const float r1 = sqrtf(q.x * q.x + q.z * q.z);
      const float dxz = r1 - c.x;
      const float dy = fabsf(q.y) - c.y;
      const float mx = fmaxf(dxz, 0.0f);
      const float my = fmaxf(dy, 0.0f);
      const float r2 = sqrtf(mx * mx + my * my);
      const float mm = fmaxf(dxz, dy);
      const float g2 = gs / (2.0f * r2);
      const float u = g2 * mx, v = g2 * my;
      const float gmm = gs * bal(mm, fminf(mm, 0.0f), 0.0f);
      const float gdxz = (u + u) * bal(dxz, mx, 0.0f) + ext_adj(gmm, dxz, dy, true);
      const float gdy = (v + v) * bal(dy, my, 0.0f) + ext_adj(gmm, dy, dxz, true);
      const float g1 = gdxz / (2.0f * r1);
      const float w = g1 * q.x, z = g1 * q.z;
      const V3 gq = mk(w + w, q.y >= 0.0f ? gdy : -gdy, z + z);
      acc3(A, ia, gq);
      acc3(A, ib, neg(gq));
      acc(A, ic, 0, -gdxz);
      acc(A, ic, 1, -gdy);
      break;
    }
    case OP_CAPSULE: {
      const V3 pa = sub(a, b);
      const V3 ba = sub(c, b);
      const float num = dot(pa, ba);
      const float dd = dot(ba, ba);
      const float den = fmaxf(dd, 1e-30f);
      const float r = num / den;
      const float h = clamp01(r);
      const V3 gv = length_adj(gs, sub(pa, scale(ba, h)));
      // v = pa - ba * h
      const V3 gbh = neg(gv);
      const float gh = (gbh.x * ba.x + gbh.y * ba.y) + gbh.z * ba.z;
      const float gr = clip_adj(gh, r, 0.0f, 1.0f);
      const float gnum = gr / den;
      const float gden = -gr * ((num / den) / den);
      const float gdd = gden * bal(dd, fmaxf(dd, 1e-30f), 1e-30f);
      const float tx = gdd * ba.x, ty = gdd * ba.y, tz = gdd * ba.z;
      const V3 gpa = add(gv, scale(ba, gnum));
      const V3 gba = add(add(scale(gbh, h), mk(tx + tx, ty + ty, tz + tz)), scale(pa, gnum));
      acc3(A, ia, gpa);
      acc3(A, ib, neg(add(gpa, gba)));
      acc3(A, ic, gba);
      acc(A, ie, 0, -gs);
      break;
    }
    case OP_UNION:
    case OP_SUBTRACT:
    case OP_INTERSECT:
      for (int k = 0; k < 3; ++k) {
        if (!(lm & (1 << k))) continue;
        const float gk = at(g, k);
        const float ak = at(a, k);
        const float bk = at(b, k);
        if (op == OP_UNION) {
          acc(A, ia, k, ext_adj(gk, ak, bk, false));
          acc(A, ib, k, ext_adj(gk, bk, ak, false));
        } else if (op == OP_SUBTRACT) {
          acc(A, ia, k, ext_adj(gk, ak, -bk, true));
          acc(A, ib, k, -ext_adj(gk, -bk, ak, true));
        } else {
          acc(A, ia, k, ext_adj(gk, ak, bk, true));
          acc(A, ib, k, ext_adj(gk, bk, ak, true));
        }
      }
      break;
    case OP_SMOOTH_UNION: {
      const float x1 = 0.5f * (b.x - a.x);
      const float uu = 0.5f + x1 / c.x;
      const float h = clamp01(uu);
      const float omh = 1.0f - h;
      const float kh = c.x * h;
      // (b (1 - h) + a h) - (k h) (1 - h), two separate (1 - h)
      const float grhs = -gs;
      const float gkh = grhs * omh;
      const float gh = ((gs * a.x + gkh * c.x) + -(gs * b.x)) + -(grhs * kh);
      const float gu = clip_adj(gh, uu, 0.0f, 1.0f);
      const float gx1 = gu / c.x;
      const float gdiff = gx1 * 0.5f;
      acc(A, ia, 0, gs * h - gdiff);
      acc(A, ib, 0, gs * omh + gdiff);
      acc(A, ic, 0, gkh * h + -gu * ((x1 / c.x) / c.x));
      break;
    }
    case OP_REPEAT:
      for (int k = 0; k < 3; ++k) {
        if (!(lm & (1 << k))) continue;
        const float gk = at(g, k);
        const float per = at(b, k);
        acc(A, ia, k, gk);
        if (per != 0.0f) {
          acc(A, ib, k, -gk * floor_div(at(a, k), per) + -gk * 0.5f);
        }
      }
      break;
    case OP_GETX:
      acc(A, ia, 0, gs);
      break;
    case OP_GETY:
      acc(A, ia, 1, gs);
      break;
    case OP_GETZ:
      acc(A, ia, 2, gs);
      break;
    default:  // the componentwise arithmetic
      for (int k = 0; k < 3; ++k) {
        if (!(lm & (1 << k))) continue;
        const float gk = at(g, k);
        const float ak = at(a, k);
        const float bk = at(b, k);
        switch (op) {
          case OP_ADD:
            acc(A, ia, k, gk);
            acc(A, ib, k, gk);
            break;
          case OP_SUB:
            acc(A, ia, k, gk);
            acc(A, ib, k, -gk);
            break;
          case OP_MUL:
            acc(A, ia, k, gk * bk);
            acc(A, ib, k, gk * ak);
            break;
          case OP_DIV:
            acc(A, ia, k, gk / bk);
            acc(A, ib, k, -gk * ((ak / bk) / bk));
            break;
          case OP_SIN:
            acc(A, ia, k, gk * cosf(ak));
            break;
          default:  // OP_COS
            acc(A, ia, k, gk * -sinf(ak));
            break;
        }
      }
      break;
  }
}

// The gradient of map_dist at p.  The running minimum's cotangents follow
// torch.minimum's (and jnp.minimum's) chain from object 0: among the t
// objects at the minimum,
// the first gets 0.5^(t-1) and the i-th (i > 1) 0.5^(t-i+1) (a three-way
// tie: 0.25 / 0.25 / 0.5), every other object 0.  Every object is swept,
// those of cotangent 0 too, as JAX's vjp sweeps them.  A call, so that
// the kernels keep their own registers around it; only the exact-normal
// instantiations contain it.
__device__ __noinline__ V3 grad_map(const SceneRef& s, float max_dist, V3 p) {
  const int n_obj = s.prog()[0];
  if (n_obj == 0) return splat(0.0f);
  float dmin = eval_object(s, 0, p);
  int n_tie = 1;  // objects at the running minimum
  for (int i = 1; i < n_obj; ++i) {
    const float di = eval_object(s, i, p);
    n_tie = di < dmin ? 1 : (di == dmin ? n_tie + 1 : n_tie);
    dmin = fminf(dmin, di);
  }
  V3 dp = splat(0.0f);
  int rank = 0;  // tied objects at or after i
  for (int i = n_obj - 1; i >= 0; --i) {
    const float di = run_object<true>(s, i, p);
    float cot = 0.0f;
    if (di == dmin) {
      rank += 1;
      cot = ldexpf(1.0f, -(rank == n_tie ? n_tie - 1 : rank));
    }
    const int* od = s.prog() + kHeader + kObjWords * i;
    const int dist = od[2] & kRegMask;
    Adj A = adj_file(s);
    const int n_live = od[1] < s.prog()[3] ? od[1] : s.prog()[3];
    for (int k = 0; k < n_live; ++k) A.live[k * kBlockThreads] = 0;
    A.live[dist * kBlockThreads] = 1;
    A.v[3 * dist * kBlockThreads] = cot;
    for (int k = od[1] - 1; k >= 0; --k) {
      node_adjoint(s, p, s.prog() + od[0] + kNodeWords * k, A);
    }
    dp = add(dp, A.dp);
  }
  return dp;
}

// SDF-gradient normal: 4 tetrahedron taps or 6 central differences, or,
// in an exact-normal instantiation (normal_taps = 0), the normalised
// reverse sweep.  kExact is a template argument so that the stencil
// instantiations compile to the code they had without grad_map.
template <bool kExact>
__device__ V3 get_normal(const SceneRef& s, float max_dist, float e, int taps, V3 p) {
  if constexpr (kExact) return normalized(grad_map(s, max_dist, p));
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

// A kernel policy B with the exact normal: the lane machines read
// `R::kExact` (false in every base policy) and pass it to get_normal, and
// each entry point launches ExactNormal<B> when normal_taps is 0.
template <class B>
struct ExactNormal : B {
  static constexpr bool kExact = true;
  ExactNormal() = default;
  explicit ExactNormal(const B& b) : B(b) {}
};

// ---- the pixel queue of the persistent megakernels --------------------------
//
// The render megakernels launch only as many blocks as stay resident
// (`persistent_grid`) and hand the patch's pixels out from a global counter
// that the wrapper zeroes for every launch: a lane whose pixel's chain has
// ended writes it and takes the next.  Queue slot q is lane q % 32 of tile
// q / 32, a tile being 2 rows x 16 columns of the patch (the warp shape of
// a 16 x 8 block), tiles row-major; the lanes of a warp that ask together
// take consecutive slots, so they stay neighbours.
constexpr int kTileW = 16;
constexpr int kTileH = 2;

__host__ __device__ __forceinline__ int queue_len(int pw, int ph) {
  return ((pw + kTileW - 1) / kTileW) * ((ph + kTileH - 1) / kTileH) * 32;
}

// the pixel (lx, ly) of queue slot q; false where it falls outside the patch
__device__ __forceinline__ bool queue_pixel(int pw, int ph, int q, int& lx, int& ly) {
  const int tiles_x = (pw + kTileW - 1) / kTileW;
  const int tile = q >> 5;
  const int k = q & 31;
  lx = (tile % tiles_x) * kTileW + (k & (kTileW - 1));
  ly = (tile / tiles_x) * kTileH + (k >> 4);
  return lx < pw && ly < ph;
}

// A queue slot for every lane of the warp that asks, by one atomicAdd per
// warp (every lane of the warp calls this together).
__device__ __forceinline__ int take_slot(int* queue, bool ask) {
  const unsigned asks = __ballot_sync(0xffffffffu, ask);
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  int base = 0;
  if (asks != 0u) {
    const int leader = __ffs(asks) - 1;
    if (lane == leader) base = atomicAdd(queue, __popc(asks));
    base = __shfl_sync(0xffffffffu, base, leader);
  }
  return base + __popc(asks & ((1u << lane) - 1u));
}

#ifdef __CUDACC__
// The grid of a persistent kernel: as many blocks of kBlockThreads as stay
// resident on the card with `bytes` of dynamic shared memory each, and no
// more than `n_slots` lanes need.  Returns the CUDA error.
template <class K>
inline cudaError_t persistent_grid(K kernel, size_t bytes, int device, int n_slots, int& grid) {
  int per_sm = 0, n_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int need = (n_slots + kBlockThreads - 1) / kBlockThreads;
  const int resident = (per_sm > 0 ? per_sm : 1) * n_sm;
  grid = need < resident ? need : resident;
  if (grid < 1) grid = 1;
  return cudaSuccess;
}
#endif

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
