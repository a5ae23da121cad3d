"""Shared helpers of the PyTorch port's parity tests (`test_torch_*.py`).

Each test feeds the same numpy inputs, made from a seed, to a JAX function
of `raymarchrenderer_tpu` and its counterpart in `raymarchrenderer_tpu_torch`
and states its tolerance.  torch runs one thread per process, because the
suite runs under several xdist workers.  This module imports no JAX, so
the card's tests can use it where JAX is not installed.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from _torch_scenes import BIG_OBJECT_SCENE, many_lights_scene  # noqa: F401

torch.set_num_threads(1)

# The bar the JAX package sets for its own kernel against its oracle
# (tests/test_kernels.py): fewer than 1e-3 of the image values off by more
# than 1e-5.  A spectral pixel either matches or differs because one path
# changed topology (hit/miss, material, absorption), so the count of
# off values counts flipped paths.
PIX_TOL = 1e-5
MAX_FRAC_OFF = 1e-3


def frac_off(a, b, tol: float = PIX_TOL) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)) > tol).mean())


def assert_nee_close(want, got):
    """The JAX package's own NEE bar (tests/test_mega.py TestMegaNEE):
    fewer than 1e-3 of the values off by more than 1e-3, and
    rtol 5e-3 / atol 1e-3.  Next-event estimation adds
    cos * power / dist^2 / pi at every hit, float math through sqrt, sin,
    cos and rsqrt, so an NEE image is close, not bitwise."""
    want, got = np.asarray(want), np.asarray(got)
    d = np.abs(want - got)
    assert float((d > 1e-3).mean()) < 1e-3, (d.max(), (d > 1e-3).mean())
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-3)


# t of a march against the JAX package's (tests/test_torch_march.py,
# test_torch_record.py): 1e-6 relative, but on fewer than 5e-3 of the
# lanes, where XLA:CPU's 1-ulp sqrt moves a grazing hit to the
# neighbouring march step (< 1e-3 away).  A later bounce's t starts from a
# hit point and a direction through sin, cos and rsqrt: fewer than 5% of
# those entries off by more than 1e-4 (a tenth of hit_eps), none by 2e-2.
T_RTOL = 1e-6
T_FRAC_OFF = 5e-3
T_STEP = 1e-3
LATER_TOL = 1e-4
LATER_FRAC_OFF = 0.05
LATER_MAX = 2e-2


def assert_t_close(want, got):
    """t to T_RTOL relative, but on fewer than T_FRAC_OFF of the lanes,
    which may be one march step (< T_STEP) apart."""
    want, got = np.asarray(want), np.asarray(got)
    d = np.abs(want - got)
    off = d > T_RTOL * np.maximum(np.abs(want), 1.0)
    assert float(off.mean()) < T_FRAC_OFF, (float(off.mean()), d.max())
    assert float(d.max()) < T_STEP, float(d.max())


def assert_banked_t_close(want, got, n_first):
    """t banks with the slot axis first: the first `n_first` slots are
    bounce 0 (the march bar), the rest later bounces (see above)."""
    want, got = np.asarray(want), np.asarray(got)
    assert_t_close(want[:n_first], got[:n_first])
    d = np.abs(want[n_first:] - got[n_first:])
    off = float((d > LATER_TOL).mean())
    assert off < LATER_FRAC_OFF, off
    assert float(d.max()) < LATER_MAX, float(d.max())


def bank_parity(got: dict, want: dict, bounce_axis=None) -> dict:
    """Kernel planes against plain planes (the same device): the fraction
    of entries whose mid or hit differ ("decisions"), of sd entries that
    differ ("sd"); where both hit, of bounce-0 entries (all of a march
    plane) with t off by more than 1e-5 ("t"), and of later bounces'
    (banks, t's bounce axis `bounce_axis`) off by more than LATER_TOL
    ("t_later", with its max "max_later")."""
    hit = (got["hit"] > 0) & (want["hit"] > 0)
    dt = torch.where(hit, (got["t"] - want["t"]).abs(), 0.0)
    first = torch.ones_like(hit)
    if bounce_axis is not None:
        first = first.movedim(bounce_axis, 0)
        first[1:] = False
        first = first.movedim(0, bounce_axis)
    n0, n1 = max(int((hit & first).sum()), 1), max(int((hit & ~first).sum()),
                                                   1)
    out = {"decisions": float(((got["mid"] != want["mid"])
                               | (got["hit"] != want["hit"])).float().mean()),
           "t": float(((dt > 1e-5) & first).sum()) / n0,
           "t_later": float(((dt > LATER_TOL) & ~first).sum()) / n1,
           "max_later": float(torch.where(first, 0.0, dt).max())}
    if "sd" in want:
        out["sd"] = float((got["sd"] != want["sd"]).float().mean())
    return out


def np_tree(tree):
    """A JAX pytree -> the same nesting of numpy arrays."""
    import jax     # the card's tests (test_torch_cuda.py) run without JAX
    return jax.tree.map(np.asarray, tree)


def corners_to_torch(corners, device="cpu") -> torch.Tensor:
    """The JAX package's five (3,) corner arrays -> the port's (5, 3)."""
    return torch.tensor(np.stack([np.asarray(c) for c in corners]),
                        dtype=torch.float32, device=device)


def mats_to_torch(mats, device="cpu"):
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        SpectralMaterials)
    return SpectralMaterials.from_numpy(*[np.asarray(a) for a in mats],
                                        device=device)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


# One scene that uses every one of the 20 object node types, for the map,
# normal and kernel parity tests (the repo's own scene files use four).
ALL_NODES_SCENE = json.dumps({
    "materials": [
        {"id": 0, "nodes": [{"name": "shader_diffuse",
                             "inputs": [[0.8, 0.8, 0.8]],
                             "outputs": ["color", "dir"]}],
         "color": "color", "dir": "dir",
         "spectral": {"min_wave": 400.0, "max_wave": 700.0, "power": 0.8}},
        {"id": 1, "nodes": [{"name": "shader_emission",
                             "inputs": [[1, 1, 1], [6, 6, 6]],
                             "outputs": ["color"]}],
         "color": "color", "dir": -1,
         "spectral": {"min_wave": 380.0, "max_wave": 780.0, "power": 6.0,
                      "kind": 1}},
        {"id": 2, "nodes": [{"name": "shader_diffuse",
                             "inputs": [[0.2, 0.5, 0.9]],
                             "outputs": ["color", "dir"]}],
         "color": "color", "dir": "dir"},
    ],
    "objects": [
        {"matID": 0, "distance": 2, "nodes": [
            {"name": "map_torus", "inputs": [-1, [0, 1, 0], [1.0, 0.3, 0]],
             "outputs": [0]},
            {"name": "map_cylinder", "inputs": [-1, [2, 1, 0], [0.5, 1.0, 0]],
             "outputs": [1]},
            {"name": "op_union", "inputs": [0, 1], "outputs": [2]}]},
        {"matID": 2, "distance": "d", "nodes": [
            {"name": "map_capsule",
             "inputs": [-1, [-2, 0.5, 0], [-2, 2, 0], [0.3, 0.3, 0.3]],
             "outputs": ["cap"]},
            {"name": "map_box", "inputs": [-1, [-2, 1, 0], [0.4, 0.4, 0.4]],
             "outputs": ["box"]},
            {"name": "op_intersect", "inputs": ["cap", "box"],
             "outputs": ["i"]},
            {"name": "map_sphere", "inputs": [-1, [-2, 1.5, 0], 0.5],
             "outputs": ["s"]},
            {"name": "op_smooth_union", "inputs": ["i", "s", 0.2],
             "outputs": ["d"]}]},
        {"matID": 0, "distance": 9, "nodes": [
            {"name": "map_plane", "inputs": [-1, [0, 1, 0.05], 0.0],
             "outputs": [0]},
            {"name": "misc_getY", "inputs": [-1], "outputs": [1]},
            {"name": "math_sine", "inputs": [1], "outputs": [2]},
            {"name": "math_multiply", "inputs": [2, 0.05], "outputs": [3]},
            {"name": "math_add", "inputs": [0, 3], "outputs": [4]},
            {"name": "math_cosine", "inputs": [1], "outputs": [5]},
            {"name": "math_divide", "inputs": [5, 40.0], "outputs": [6]},
            {"name": "math_subtract", "inputs": [4, 6], "outputs": [7]},
            {"name": "misc_getX", "inputs": [7], "outputs": [8]},
            {"name": "misc_getZ", "inputs": [8], "outputs": [9]}]},
        {"matID": 1, "distance": 2, "nodes": [
            {"name": "domain_repeat", "inputs": [-1, [6, 0, 6]],
             "outputs": [0]},
            {"name": "map_sphere", "inputs": [0, [0, 5, 0], [0.8, 0.8, 0.8]],
             "outputs": [1]},
            {"name": "map_box", "inputs": [-1, [0, 5, 0], [30, 0.3, 30]],
             "outputs": [3]},
            {"name": "op_subtract", "inputs": [1, 3], "outputs": [2]}]},
    ],
    "environment": {"power": 0.05},
})


# One scene that uses every material node of both scene formats (the gen-1
# register machine and the gen-2 new format, with an unreachable node), a
# sphere light for NEE and every object primitive the RGB path meets in
# the builtins, for the shading, schedule and kernel parity tests.
ALL_MATERIALS_SCENE = json.dumps({
    "materials": [
        {"id": 0, "nodes": [
            {"name": "shader_diffuse", "inputs": [[0.75, 0.75, 0.75]],
             "outputs": ["c", "d"]},
            {"name": "misc_fresnel", "outputs": ["fr"]},
            {"name": "math_sine", "inputs": [[0.3, 0.2, 0.1]],
             "outputs": ["s"]},
            {"name": "math_cosine", "inputs": ["s"], "outputs": ["co"]},
            {"name": "math_add", "inputs": ["s", "co"], "outputs": ["a"]},
            {"name": "math_subtract", "inputs": ["a", "fr"],
             "outputs": ["b"]},
            {"name": "math_divide", "inputs": ["b", 2.5], "outputs": ["q"]},
            {"name": "math_multiply", "inputs": ["q", [0.9, 0.8, 0.7]],
             "outputs": ["tint2"]}],
         "color": "tint2", "dir": "d"},
        {"id": 1, "nodes": [
            {"name": "shader_diffuse", "inputs": [[0.8, 0.2, 0.2]],
             "outputs": ["dc", "dd"]},
            {"name": "shader_glossy", "inputs": [[0.9, 0.9, 0.9], 0.1],
             "outputs": ["gc", "gd"]},
            {"name": "misc_facing", "outputs": ["f"]},
            {"name": "shader_mix", "inputs": ["gc", "gd", "dc", "dd", "f"],
             "outputs": ["color", "dir"]}],
         "color": "color", "dir": "dir"},
        {"id": 2, "nodes": [
            {"name": "shader_refraction",
             "inputs": [[0.8, 0.9, 0.8], 1.45, [0.02, 0.02, 0.02]],
             "outputs": [0, 1, 2]},
            {"name": "shader_glossy", "inputs": [[0.8, 0.9, 0.8], 0.02],
             "outputs": [3, 4]},
            {"name": "misc_facing", "outputs": [5]},
            {"name": "misc_inside", "outputs": [6]},
            {"name": "math_add", "inputs": [5, 6], "outputs": [7]},
            {"name": "shader_mix", "inputs": [3, 4, [0, 0, 0], 0, 1, 2, 7],
             "outputs": [8, 9, 10]}],
         "color": 8, "dir": 9, "inside": 10},
        {"id": 3, "nodes": [
            {"name": "shader_volumeScatter",
             "inputs": [[0.6, 0.7, 0.9], 2.0], "outputs": [0, 1, 2, 3]}],
         "color": 0, "dir": 1, "inside": 2, "hit": 3},
        {"id": 4, "nodes": [
            {"name": "shader_emission", "inputs": [[1, 0.9, 0.8], 12.0],
             "outputs": ["color"]}],
         "color": "color", "dir": -1},
        {"id": 5, "constants": [[0.75, 0.25, 0.2], [0.95, 0.95, 0.95], 0.3,
                                0.0, 0.4, [0.2, 0.9, 0.3]],
         "nodes": [
             {"name": "shader_diffuse", "inputs": [[-1, 0]]},
             {"name": "shader_glossy", "inputs": [[-1, 1], [-1, 2]]},
             {"name": "shader_mix", "inputs": [[0, 0], [1, 0], [3, 0]]},
             {"name": "misc_fresnel"},
             {"name": "shader_glossy", "inputs": [[-1, 1], [-1, 3]]},
             {"name": "shader_mix", "inputs": [[2, 0], [4, 0], [-1, 4]]},
             {"name": "shader_diffuse", "inputs": [[-1, 5]]}],
         "output": 5},
        {"id": 6, "nodes": [
            {"name": "shader_refraction", "inputs": [[0.9, 0.9, 1.0], 1.3],
             "outputs": ["c", "d", "i"]}],
         "color": "c", "dir": "d", "inside": "i"},
    ],
    "objects": [
        {"matID": 0, "distance": 0, "nodes": [
            {"name": "map_box", "inputs": [-1, [0, -0.025, 0],
                                           [32, 0.05, 32]], "outputs": [0]}]},
        {"matID": 1, "distance": 0, "nodes": [
            {"name": "map_sphere", "inputs": [-1, [-2.2, 0.8, 0], 0.8],
             "outputs": [0]}]},
        {"matID": 2, "distance": 0, "nodes": [
            {"name": "map_box", "inputs": [-1, [0, 0.8, -0.5],
                                           [0.7, 0.7, 0.1]], "outputs": [0]}]},
        {"matID": 3, "distance": 0, "nodes": [
            {"name": "map_sphere", "inputs": [-1, [0, 0.9, 1.5], 0.9],
             "outputs": [0]}]},
        {"matID": 4, "distance": 0, "nodes": [
            {"name": "map_sphere", "inputs": [-1, [5, 7, -4], 2.0],
             "outputs": [0]}]},
        {"matID": 5, "distance": 0, "nodes": [
            {"name": "map_sphere", "inputs": [-1, [2.2, 0.8, 0], 0.8],
             "outputs": [0]}]},
        {"matID": 6, "distance": 0, "nodes": [
            {"name": "map_sphere", "inputs": [-1, [1.0, 0.5, -1.6], 0.5],
             "outputs": [0]}]},
    ],
    "lights": [{"pos": [3, 7, -3], "power": 60.0, "radius": 0.8}],
    "environment": {"power": 0.05},
})

