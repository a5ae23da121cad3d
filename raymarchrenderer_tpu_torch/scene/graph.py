"""Scene IR: `.scene` JSON node graphs -> a static `Scene` + a parameter dict.

The port's twin of the JAX package's `scene/graph.py`.  Parsing is the same
Python over the same JSON, so both packages see the same structure and the
same float32 constants.  Graph constants are pulled into a nested parameter
dict (`Scene.init_params`) of float32 tensors, with the same nesting and
leaf order as the JAX package's pytree:

    {"materials": [[leaf, ...], ...], "objects": [[leaf, ...], ...],
     "lights": {"pos", "power", "radius"}, "env": {"power"[, "sh"]}}

`Scene.map` / `Scene.map_dist` evaluate the object graphs eagerly over a
batch of points; the CUDA kernel runs the same graphs from the compiled
program of `kernels/scene_program.py`.

Both reference scene-format generations parse (`Graphics.cpp:412-463` new
format, the old register format), including the gen-3 `spectral` blocks.
Material graphs are parsed but not evaluated: that is the RGB transport's
part.  Env-image skies are not supported by this package yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.scene.nodes import OBJECT_NODES

# input descriptors (static structure), as in the JAX package
_PARAM = "param"   # ('param', param_index)
_VAR = "var"       # ('var', register_key)
_POINT = "point"   # ('point',) — the sample point p (object graphs, -1)
_NODE = "node"     # ('node', node_index, out_index) — new format


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    inputs: Tuple[Tuple, ...]
    outputs: Tuple[Any, ...] = ()


@dataclasses.dataclass(frozen=True)
class MaterialDef:
    mat_id: int
    fmt: str                           # 'old' | 'new'
    nodes: Tuple[NodeSpec, ...]
    bindings: Tuple[Any, Any, Any, Any] = (-1, -1, -1, -1)  # color,dir,inside,hit
    output: int = -1                   # new format: final node index


@dataclasses.dataclass(frozen=True)
class ObjectDef:
    mat_id: int
    nodes: Tuple[NodeSpec, ...]
    distance: Any = 0                  # register key of the distance output


def _as_param(value) -> np.ndarray:
    if isinstance(value, (list, tuple)):
        return np.asarray(value, np.float32)
    return np.asarray(float(value), np.float32)


def _param_to_vec3(a: torch.Tensor) -> Vec3:
    """Broadcastable Vec3 view of a parameter: (3,) -> components, () -> splat."""
    if a.ndim == 0:
        return Vec3(a, a, a)
    return Vec3(a[0], a[1], a[2])


class _Parser:
    """Collects graph constants into an ordered parameter list."""

    def __init__(self):
        self.params: List[np.ndarray] = []

    def const(self, value) -> Tuple:
        self.params.append(_as_param(value))
        return (_PARAM, len(self.params) - 1)


def _parse_material(m: dict) -> Tuple[MaterialDef, List[np.ndarray]]:
    p = _Parser()
    if "output" in m:  # new format
        consts = [_as_param(c) for c in m.get("constants", [])]
        nodes = []
        for n in m["nodes"]:
            ins = []
            for ref in n.get("inputs", []):
                a, b = int(ref[0]), int(ref[1])
                ins.append((_PARAM, b) if a == -1 else (_NODE, a, b))
            nodes.append(NodeSpec(n["name"], tuple(ins)))
        mat = MaterialDef(int(m["id"]), "new", tuple(nodes),
                          output=int(m["output"]))
        return mat, consts

    nodes = []
    for n in m["nodes"]:
        ins = []
        for ref in n.get("inputs", []):
            if isinstance(ref, (list, tuple)) or isinstance(ref, float):
                ins.append(p.const(ref))
            else:
                ins.append((_VAR, ref))
        outs = tuple(n.get("outputs", []))
        nodes.append(NodeSpec(n["name"], tuple(ins), outs))
    bind = tuple(m.get(k, -1) for k in ("color", "dir", "inside", "hit"))
    return MaterialDef(int(m["id"]), "old", tuple(nodes), bind), p.params


def _parse_object(o: dict) -> Tuple[ObjectDef, List[np.ndarray]]:
    p = _Parser()
    nodes = []
    for n in o["nodes"]:
        ins = []
        for ref in n.get("inputs", []):
            if isinstance(ref, int) and ref == -1:
                ins.append((_POINT,))
            elif isinstance(ref, (list, tuple)) or isinstance(ref, float):
                ins.append(p.const(ref))
            else:
                ins.append((_VAR, ref))
        nodes.append(NodeSpec(n["name"], tuple(ins),
                              tuple(n.get("outputs", []))))
    return (ObjectDef(int(o["matID"]), tuple(nodes), o.get("distance", 0)),
            p.params)


def params_from_numpy(tree, device) -> Any:
    """A nested dict/list of array-likes (the JAX package's parameter
    pytree after `np.asarray`, or parse-time numpy values) -> the same
    nesting of tensors on `device`, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)  # a writable copy


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene structure; every evaluation takes the parameter dict,
    so the scene is a pure function of its parameters."""

    materials: Tuple[MaterialDef, ...]
    objects: Tuple[ObjectDef, ...]
    n_lights: int = 0
    has_sh_env: bool = False
    # gen-3 band-filter rows (min_wave, max_wave, power, kind) aligned with
    # `materials`, from each material's optional `spectral` block; empty =
    # none authored (`render.spectral_integrator.band_table` then derives
    # the neutral default)
    spectral_rows: Tuple[Tuple[float, float, float, int], ...] = ()

    # parse-time initial values (not part of the static hash)
    _init: dict = dataclasses.field(default=None, compare=False, hash=False,
                                    repr=False)

    def init_params(self, device="cpu") -> dict:
        return params_from_numpy(self._init, device)

    def mat_index(self, mat_id: int) -> int:
        for i, m in enumerate(self.materials):
            if m.mat_id == mat_id:
                return i
        raise KeyError(f"material id {mat_id} not in scene")

    def is_emissive(self, i: int) -> bool:
        """True if material i's graph reaches shader_emission (terminal)."""
        return any(n.name == "shader_emission"
                   for n in self.materials[i].nodes)

    def map(self, params: dict, p: Vec3, max_dist: float):
        """(dist, mat_index) at p: the generated `map()` fold
        (`RayMarch.glsl:224-231`), seeded with `max_dist` and -1, taking an
        object where its distance is strictly smaller."""
        shape = p.x.shape
        d = torch.full(shape, max_dist, dtype=torch.float32,
                       device=p.x.device)
        mid = torch.full(shape, -1, dtype=torch.int32, device=p.x.device)
        for oi, obj in enumerate(self.objects):
            di = _eval_object(obj, params["objects"][oi], p)
            take = di < d
            d = torch.where(take, di, d)
            mid = torch.where(take, self.mat_index(obj.mat_id), mid)
        return d, mid

    def map_dist(self, params: dict, p: Vec3, max_dist: float):
        """Distance only: a running minimum seeded from object 0's
        distance (no `max_dist` splat), as in the JAX package."""
        if not self.objects:
            return torch.full(p.x.shape, max_dist, dtype=torch.float32,
                              device=p.x.device)
        d = _eval_object(self.objects[0], params["objects"][0], p)
        for oi in range(1, len(self.objects)):
            d = torch.minimum(d, _eval_object(self.objects[oi],
                                              params["objects"][oi], p))
        return d


def _resolve(desc, params, vars_, point):
    kind = desc[0]
    if kind == _PARAM:
        return _param_to_vec3(params[desc[1]])
    if kind == _VAR:
        return vars_[desc[1]]
    if kind == _POINT:
        return point
    raise ValueError(f"unresolvable input {desc}")


def _eval_object(obj: ObjectDef, params, p: Vec3):
    vars_: Dict[Any, Vec3] = {}
    for node in obj.nodes:
        fn = OBJECT_NODES[node.name]
        outs = fn(*[_resolve(d, params, vars_, p) for d in node.inputs])
        for key, val in zip(node.outputs, outs):
            vars_[key] = val
    d = vars_[obj.distance].x
    # a graph whose distance register holds only parameters is constant
    # over space: broadcast it to the batch like the JAX package's arrays
    return d.expand(p.x.shape) if d.shape != p.x.shape else d


def loads_scene(text: str) -> Scene:
    """Parse a `.scene` JSON string (either format generation)."""
    doc = json.loads(text)
    mats, mat_params = [], []
    for m in doc.get("materials", []):
        md, pp = _parse_material(m)
        mats.append(md)
        mat_params.append(pp)
    objs, obj_params = [], []
    for o in doc.get("objects", []):
        od, pp = _parse_object(o)
        objs.append(od)
        obj_params.append(pp)

    lights = doc.get("lights", [])
    light_params = {
        "pos": np.asarray([l["pos"] for l in lights],
                          np.float32).reshape(-1, 3),
        "power": np.asarray([l.get("power", 1.0) for l in lights],
                            np.float32),
        "radius": np.asarray([l.get("radius", 0.1) for l in lights],
                             np.float32),
    }

    env = doc.get("environment", {})
    env_params: Dict[str, Any] = {"power": np.float32(env.get("power", 0.015))}
    has_sh = "sh" in env
    if has_sh:
        sh = np.asarray(env["sh"], np.float32)
        if sh.shape != (16, 3):
            raise ValueError(f"env_sh must be (16, 3), got {sh.shape}")
        env_params["sh"] = sh

    # optional gen-3 spectral blocks: if ANY material declares one,
    # materials without a block get the neutral 380-780 nm x0.8 surface
    # filter (`mat_func_1`) so the rows stay aligned with `materials`
    spec_rows: Tuple[Tuple[float, float, float, int], ...] = ()
    raw_mats = doc.get("materials", [])
    if any("spectral" in m for m in raw_mats):
        spec_rows = tuple(
            (float(s.get("min_wave", 380.0)), float(s.get("max_wave", 780.0)),
             float(s.get("power", 0.8)), int(s.get("kind", 0)))
            for s in (m.get("spectral", {}) for m in raw_mats))

    init = {"materials": mat_params, "objects": obj_params,
            "lights": light_params, "env": env_params}
    return Scene(tuple(mats), tuple(objs), n_lights=len(lights),
                 has_sh_env=has_sh, spectral_rows=spec_rows, _init=init)


def load_scene(path: str) -> Scene:
    with open(path) as f:
        return loads_scene(f.read())
