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
