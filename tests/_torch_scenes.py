"""Scenes the CUDA kernels once refused, shared by the port's tests and
`chip_smoke.py`: an object of 40 nodes (the kernels had 16 registers) and
a scene with 12 lights (their NEE light table held 8).  Imports numpy and
the port only, and sets nothing."""
import json

import numpy as np


def _big_object(n_spheres: int = 20):
    """One object of 2 * n_spheres nodes: a domain repeat of the point,
    then spheres over the repeated point folded by unions, so most node
    values are forwarded and the repeated point is a stored register."""
    nodes = [{"name": "domain_repeat", "inputs": [-1, [6.0, 0.0, 6.0]],
              "outputs": ["q"]}]
    for i in range(n_spheres):
        ang = 2.0 * np.pi * i / n_spheres
        centre = [float(1.8 * np.cos(ang)), 1.0 + 0.05 * i,
                  float(1.8 * np.sin(ang))]
        nodes.append({"name": "map_sphere",
                      "inputs": ["q", centre, 0.25 + 0.01 * i],
                      "outputs": [f"s{i}"]})
        if i:
            nodes.append({"name": "op_union",
                          "inputs": [f"u{i - 1}" if i > 1 else "s0",
                                     f"s{i}"], "outputs": [f"u{i}"]})
    return {"matID": 0, "distance": f"u{n_spheres - 1}", "nodes": nodes}


# A scene with a 40-node object (40 registers: more than the 16 the
# kernels once had), on a floor, with an emitter.
BIG_OBJECT_SCENE = json.dumps({
    "materials": [
        {"id": 0, "nodes": [{"name": "shader_diffuse",
                             "inputs": [[0.7, 0.6, 0.5]],
                             "outputs": ["color", "dir"]}],
         "color": "color", "dir": "dir"},
        {"id": 1, "nodes": [{"name": "shader_emission",
                             "inputs": [[1, 1, 1], [4, 4, 4]],
                             "outputs": ["color"]}],
         "color": "color", "dir": -1}],
    "objects": [
        _big_object(),
        {"matID": 0, "distance": 0, "nodes": [
            {"name": "map_box", "inputs": [-1, [0, -0.05, 0], [8, 0.05, 8]],
             "outputs": [0]}]},
        {"matID": 1, "distance": 0, "nodes": [
            {"name": "map_sphere", "inputs": [-1, [0, 4, 0], 0.5],
             "outputs": [0]}]}],
})


def many_lights_scene(n_lights: int = 12):
    """A sphere on a floor under `n_lights` small lights in a row (more
    than the 8 the RGB kernels' light table once held)."""
    from raymarchrenderer_tpu_torch.scene import builtin
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.6, 0.6])
    b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    for i in range(n_lights):
        b.light([i - (n_lights - 1) / 2.0, 6.0, -3.0], 8.0, 0.3)
    return b.build()
