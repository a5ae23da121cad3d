"""The kernels' exact normal against its plain version, bit for bit, on
the CPU: `grad_map` of csrc/scene_map.cuh (the reverse sweep every
exact-normal kernel calls) built by g++ for the host, against
`render.integrator.exact_gradient` (torch.autograd of `Scene.map_dist`).

The kernels are built with `--fmad=false` and correctly rounded sqrt and
division; the host build here with `-ffp-contract=off`.  torch's CPU sqrt
is not always correctly rounded, so the plain side runs with a sqrt that
is (through float64) and keeps torch's own backward formula,
g / (2 sqrt x).  With that, every gradient and normal is equal bit for
bit: the plain version sums each node's cotangents in the kernel's order
(`core.sdf.smin` creates its ops so that autograd sums h's four as
`grad_map` does; in the other order 964 of csg_demo's 20000 points here
were an ulp off, all in the smooth union, and recorder #5's exact-normal
NEE patch on the card read 4.8e-7).  Scenes with sin or cos nodes are left out: the
host's libm and torch's CPU sin differ by an ulp.
"""
import ctypes
import glob
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_parity import BIG_OBJECT_SCENE

from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.diff.march import _surface_gradient
from raymarchrenderer_tpu_torch.kernels.build import CSRC
from raymarchrenderer_tpu_torch.kernels.scene_program import object_buffers
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.scene import builtin, load_scene, loads_scene

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CUDA keywords and intrinsics scene_map.cuh uses, for one host thread
_STUB = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __device__
#define __host__
#define __global__
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __align__(n) __attribute__((aligned(n)))
inline void __syncthreads() {}
typedef void* cudaStream_t;
struct rmr_dim3 { unsigned x = 0, y = 0, z = 0; };
static rmr_dim3 threadIdx, blockIdx, blockDim{128, 1, 1};
inline unsigned __ballot_sync(unsigned, bool b) { return b ? 1u : 0u; }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
inline int __shfl_sync(unsigned, int v, int) { return v; }
inline bool __all_sync(unsigned, bool b) { return b; }
"""

_ENTRY = r"""
namespace rmr { extern float rmr_smem[]; }
#include "scene_map.cuh"
namespace rmr { float rmr_smem[1 << 22]; }
using namespace rmr;
extern "C" void host_grad(const int* prog, int n_words, const float* f,
                          int n_floats, float max_dist, const float* pts,
                          int n, float* out) {
  for (int i = 0; i < n_words; ++i)
    reinterpret_cast<int*>(rmr_smem)[i] = prog[i];
  for (int i = 0; i < n_floats; ++i) rmr_smem[n_words + i] = f[i];
  SceneRef s;
  s.fo = n_words;
  s.ro = n_words + n_floats;
  for (int i = 0; i < n; ++i) {
    const V3 p = mk(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
    const V3 g = grad_map(s, max_dist, p);
    const V3 u = normalized(g);
    const float d = map_dist(s, max_dist, p);
    const float v[7] = {g.x, g.y, g.z, u.x, u.y, u.z, d};
    for (int k = 0; k < 7; ++k) out[7 * i + k] = v[k];
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("grad_map")
    (d / "cuda_runtime.h").write_text(_STUB)
    (d / "entry.cpp").write_text(_ENTRY)
    lib = d / "libgrad.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{d}", f"-I{CSRC}", "-include",
                    "cuda_runtime.h", "-o", str(lib), str(d / "entry.cpp")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


class _Sqrt(torch.autograd.Function):
    """A correctly rounded float32 sqrt with torch's backward formula."""

    @staticmethod
    def forward(ctx, x):
        r = torch.ops.aten.sqrt(x.double()).float()
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return g / (2 * r)


def _plain(scene, params, cfg, pts, monkeypatch):
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: _Sqrt.apply(x)
                        if x.dtype == torch.float32 else sqrt(x))
    t = torch.from_numpy(pts)
    p = Vec3(t[:, 0], t[:, 1], t[:, 2])
    g = _surface_gradient(scene, cfg, params, p)
    u = g.normalized()
    d = scene.map_dist(params, p, cfg.max_dist)
    monkeypatch.undo()
    return torch.stack([*g, *u, d], 1).numpy()


def _host(lib, scene, params, cfg, pts):
    prog, data, _ = object_buffers(scene, params, "cpu")
    prog, data = prog.numpy(), data.numpy()
    out = np.empty((len(pts), 7), np.float32)
    vp = ctypes.c_void_p
    lib.host_grad(vp(prog.ctypes.data), ctypes.c_int(prog.size),
                  vp(data.ctypes.data), ctypes.c_int(data.size),
                  ctypes.c_float(cfg.max_dist), vp(pts.ctypes.data),
                  ctypes.c_int(len(pts)), vp(out.ctypes.data))
    return out


def _scenes():
    out = {name: getattr(builtin, name) for name in (
        "csg_demo", "sphere_on_floor", "cornell", "glass_demo",
        "volume_demo")}
    out["big_object"] = lambda: loads_scene(BIG_OBJECT_SCENE)
    for path in sorted(glob.glob(os.path.join(_REPO, "data", "scenes",
                                              "*.scene"))):
        out[os.path.basename(path)] = (lambda p=path: load_scene(p))
    return out


@pytest.mark.parametrize("name", list(_scenes()))
def test_plain_exact_normal_equals_grad_map(host_lib, name, monkeypatch):
    scene = _scenes()[name]()
    params = scene.init_params("cpu")
    cfg = RenderConfig(normal_taps=0)
    rs = np.random.RandomState(11)
    pts = rs.uniform([-5, -1, -5], [5, 5, 5], size=(20000, 3)).astype(
        np.float32)
    got = _host(host_lib, scene, params, cfg, pts)
    want = _plain(scene, params, cfg, pts, monkeypatch)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])     # distances
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (name, int((~same.all(1)).sum()))
