"""Scene IR: `.scene` JSON node graphs -> a static `Scene` + a parameter dict.

The port's twin of the JAX package's `scene/graph.py`.  Parsing is the same
Python over the same JSON, so both packages see the same structure and the
same float32 constants.  Graph constants are pulled into a nested parameter
dict (`Scene.init_params`) of float32 tensors, with the same nesting and
leaf order as the JAX package's pytree:

    {"materials": [[leaf, ...], ...], "objects": [[leaf, ...], ...],
     "lights": {"pos", "power", "radius"},
     "env": {"power"[, "image" | "sh"]}}

`Scene.map` / `Scene.map_dist` evaluate the object graphs and
`Scene.shade` the material graphs eagerly over a batch of points; the CUDA
kernels run the same graphs from the compiled programs of
`kernels/scene_program.py`.

Both reference scene-format generations parse and shade
(`Graphics.cpp:412-463` new format with the gen-2 BRDF nodes, the old
register format with the gen-1 nodes), including the gen-3 `spectral`
blocks.  The sky (`Scene.sky`, `skyColor` of `RayMarch.glsl:78-113`) is
the constant `env.power`, an equirect env image (`env_image`, the
reference's `veranda_1k.hdr` slot, `Graphics.cpp:287`) read by
`Scene.sky_uv` ("exact": the bilinear GL_LINEAR footprint as one gather
from a quad table; "mxu": the bilinear read of the solid-angle
prefiltered table `prefilter_env`; either with `env_filter="nearest"`),
or an l <= 3 spherical-harmonic sky (`env_sh` or the scene's
`environment.sh`, `core/sh.py`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.vecmath import Vec3, div, vselect
from raymarchrenderer_tpu_torch.scene.nodes import (
    MATERIAL_NODES, OBJECT_NODES, ShadeCtx, ShaderOut, misc_fresnel,
    shader_diffuse2, shader_glossy2, shader_mix2)

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


@dataclasses.dataclass(frozen=True)
class Light:
    """A sphere light of NEE / soft shadows (an extension of the
    reference): its index into the `lights` parameters."""
    index: int


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


_NEW_FMT_NODES = {
    "shader_diffuse": shader_diffuse2,
    "shader_glossy": shader_glossy2,
    "shader_mix": shader_mix2,
}


def params_from_numpy(tree, device) -> Any:
    """A nested dict/list of array-likes (the JAX package's parameter
    pytree after `np.asarray`, or parse-time numpy values) -> the same
    nesting of tensors on `device`, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)  # a writable copy


def param_leaves(tree) -> list:
    """The leaves of a parameter tree in `jax.tree.flatten` order: dict
    keys sorted, lists in order (for a scene: env, lights, materials,
    objects)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in param_leaves(v)]
    return [tree]


def params_replace(tree, leaves) -> Any:
    """`tree` with its leaves, in `param_leaves` order, replaced by
    `leaves`."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [rebuild(v) for v in t]
        return next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def params_to_numpy(params) -> list:
    """The parameter leaves as numpy arrays, in `jax.tree.flatten` order,
    so a `leaf{i}` of a saved fit names the JAX package's leaf i."""
    return [leaf.detach().cpu().numpy() for leaf in param_leaves(params)]


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene structure; every evaluation takes the parameter dict,
    so the scene is a pure function of its parameters."""

    materials: Tuple[MaterialDef, ...]
    objects: Tuple[ObjectDef, ...]
    n_lights: int = 0
    has_env_map: bool = False
    # the env image's sampler: "linear" (GL_LINEAR, the reference's
    # sampler state) or "nearest"
    env_filter: str = "linear"
    # the env lookup: "exact" reads the full-resolution texture; "mxu"
    # reads the solid-angle prefiltered `env_mxu_res` table (the JAX
    # package contracts tent weights on the TPU's matrix unit; here the
    # same bilinear read of the table is four taps)
    env_gather: str = "exact"
    env_mxu_res: Tuple[int, int] = (32, 64)
    # SH sky: params["env"]["sh"] is a (16, 3) coefficient array
    has_sh_env: bool = False
    # gen-3 band-filter rows (min_wave, max_wave, power, kind) aligned with
    # `materials`, from each material's optional `spectral` block; empty =
    # none authored (`render.spectral_integrator.band_table` then derives
    # the neutral default)
    spectral_rows: Tuple[Tuple[float, float, float, int], ...] = ()

    # parse-time initial values (not part of the static hash)
    _init: dict = dataclasses.field(default=None, compare=False, hash=False,
                                    repr=False)
    # the kernels' compiled layouts of this scene on each device, filled at
    # the first build of each (`kernels.scene_program`); a new scene starts
    # with none
    _layouts: dict = dataclasses.field(default_factory=dict, init=False,
                                       compare=False, hash=False, repr=False)

    def init_params(self, device="cuda") -> dict:
        """The parse-time parameter values as tensors on `device` (the
        card by default; pass "cpu" for the plain PyTorch versions)."""
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
        distance (no `max_dist` splat), as in the JAX package; its ties
        split as `jnp.minimum`'s do (three objects at the minimum: 0.25 /
        0.25 / 0.5)."""
        if not self.objects:
            return torch.full(p.x.shape, max_dist, dtype=torch.float32,
                              device=p.x.device)
        d = _eval_object(self.objects[0], params["objects"][0], p)
        for oi in range(1, len(self.objects)):
            d = torch.minimum(d, _eval_object(self.objects[oi],
                                              params["objects"][oi], p))
        return d

    def shade(self, params: dict, ctx: ShadeCtx, mat_index) -> ShaderOut:
        """Evaluate every material graph with the one context (so material
        i draws its random numbers after those of materials 0..i-1) and
        select by per-pixel material index; -1 selects all zeros (the
        generated GLSL switch, `Graphics.cpp:69-88`)."""
        z = torch.zeros(ctx.t.shape, dtype=torch.float32,
                        device=ctx.t.device)
        zero = Vec3(z, z, z)
        out = ShaderOut(zero, zero, zero, zero)
        for i, mat in enumerate(self.materials):
            s = _eval_material(mat, params["materials"][i], ctx)
            take = mat_index == i
            out = ShaderOut(*(vselect(take, a, b) for a, b in zip(s, out)))
        return out

    def sky(self, params: dict, direction: Vec3) -> Vec3:
        """`skyColor` (`RayMarch.glsl:78-113`): the equirect env image
        when present (u = atan2(z, x) / 2 pi wrapped to [0, 1), v = 1 -
        (y * 0.5 + 0.5), read by `sky_uv`), else the SH sky, else the
        constant vec3(power)."""
        if self.has_env_map:
            two_pi = 2.0 * np.pi
            phi = torch.atan2(direction.z, direction.x)
            phi = torch.where(phi < 0, phi + two_pi, phi)
            u = div(phi, two_pi)
            v = 1.0 - (direction.y * 0.5 + 0.5)
            return self.sky_uv(params, u, v)
        if self.has_sh_env:
            from raymarchrenderer_tpu_torch.core.sh import sh_eval
            return sh_eval(params["env"]["sh"], direction)
        c = params["env"]["power"].to(torch.float32).expand(
            direction.x.shape)
        return Vec3(c, c, c)

    def sky_uv(self, params: dict, u, v) -> Vec3:
        """The equirect lookup at (u, v), the GL_LINEAR footprint of the
        reference's sampler: u wraps (phi is periodic), v clamps (the
        poles), texel centres at half-integers.  "exact" reads the
        full-resolution image with one gather per lookup from a quad table
        whose row (y, x) holds the 2 x 2 footprint (the wrap and the clamp
        baked into its padding), weighted in the JAX package's order;
        `env_gather="mxu"` reads the prefiltered table (`_sky_uv_table`).
        `env_filter="nearest"` takes the one texel under (u, v)."""
        img = params["env"]["image"]          # (H, W, 3) linear float32
        if self.env_gather == "mxu":
            kh, kw = self.env_mxu_res
            return _sky_uv_image(prefilter_env(img, kh, kw), u, v,
                                 self.env_filter)
        return _sky_uv_image(img, u, v, self.env_filter)

    def light(self, params: dict, i: int):
        """(position, power, radius) of sphere light i."""
        lp = params["lights"]
        return _param_to_vec3(lp["pos"][i]), lp["power"][i], lp["radius"][i]


def _sky_uv_image(img, u, v, env_filter: str) -> Vec3:
    """GL_LINEAR (or GL_NEAREST) read of the (h, w, 3) equirect `img` at
    (u, v), as `Scene.sky_uv` describes.  On the prefiltered table this is
    the JAX package's "mxu" lookup: its (N, K) tent-weight contraction has
    at most four non-zero weights per row, the same bilinear kernel with
    the same wrap and clamp, so four taps give what the contraction gives
    without the (N, K) matrix (to 6e-8 in the JAX package's own probe)."""
    h, w = img.shape[0], img.shape[1]
    if env_filter == "nearest":
        x0 = torch.remainder(torch.floor(u * w).to(torch.int32), w)
        y0 = torch.clamp(torch.floor(v * h).to(torch.int32), 0, h - 1)
        texel = img.reshape(h * w, 3)[(y0 * w + x0).long()]
        return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])
    x = u * w - 0.5
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = torch.remainder(x0f.to(torch.int32), w)       # wrap in phi
    y0 = torch.clamp(y0f.to(torch.int32), 0, h - 1)    # clamp at the poles
    img_pad = torch.cat([img, img[:, :1]], dim=1)
    img_pad = torch.cat([img_pad, img_pad[-1:]], dim=0)
    quad = torch.cat([img_pad[:-1, :-1], img_pad[:-1, 1:],
                      img_pad[1:, :-1], img_pad[1:, 1:]], dim=-1)
    r = quad.reshape(h * w, 12)[(y0 * w + x0).long()]
    t00, t10 = r[..., 0:3], r[..., 3:6]
    t01, t11 = r[..., 6:9], r[..., 9:12]
    texel = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
             + (t01 * (1 - fx) + t11 * fx) * fy)
    return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])


def prefilter_env(img, kh: int, kw: int):
    """Solid-angle box prefilter of an equirect (h, w, 3) map to at most
    (kh, kw, 3): each block averages its texels with sin(theta_row)
    weights, normalised per block, so a table texel is the mean radiance
    over the solid angle it covers.  The target shrinks to the largest
    divisors of (h, w) not above (kh, kw); an image already that small is
    returned as it is."""
    h, w = img.shape[0], img.shape[1]
    kh = min(kh, h)
    kw = min(kw, w)
    while h % kh:
        kh -= 1
    while w % kw:
        kw -= 1
    if (kh, kw) == (h, w):
        return img
    by, bx = h // kh, w // kw
    theta = (torch.arange(h, dtype=torch.float32, device=img.device)
             + 0.5) * (np.pi / h)
    wgt = torch.sin(theta)[:, None, None]                      # (h, 1, 1)
    num = (img * wgt).reshape(kh, by, kw, bx, 3).sum((1, 3))
    den = wgt.expand(h, w, 1).reshape(kh, by, kw, bx, 1).sum((1, 3))
    return num / den


def _resolve(desc, params, vars_, point):
    kind = desc[0]
    if kind == _PARAM:
        return _param_to_vec3(params[desc[1]])
    if kind == _VAR:
        return vars_[desc[1]]
    if kind == _POINT:
        return point
    raise ValueError(f"unresolvable input {desc}")


def _eval_material(mat: MaterialDef, params, ctx: ShadeCtx) -> ShaderOut:
    """One material graph.  New format: the memoised depth-first walk from
    the output node, so a node's draws follow its inputs' and unreachable
    nodes draw nothing.  Old format: the node list in order, a register
    machine; an unbound output register reads as zero."""
    z = torch.zeros(ctx.t.shape, dtype=torch.float32, device=ctx.t.device)
    zero = Vec3(z, z, z)
    if mat.fmt == "new":
        memo: Dict[int, Any] = {}

        def ev(ni: int):
            if ni in memo:
                return memo[ni]
            node = mat.nodes[ni]
            ins = [_param_to_vec3(params[d[1]]) if d[0] == _PARAM
                   else ev(d[1]) for d in node.inputs]
            if node.name == "misc_fresnel":
                out = misc_fresnel(ctx)[0]
            elif node.name in _NEW_FMT_NODES:
                out = _NEW_FMT_NODES[node.name](ctx, *ins)
            else:
                raise KeyError(f"unknown new-format node {node.name}")
            memo[ni] = out
            return out

        out = ev(mat.output)
        if not isinstance(out, ShaderOut):
            raise ValueError("new-format material output node must be a "
                             "shader")
        return out

    vars_: Dict[Any, Vec3] = {}
    for node in mat.nodes:
        fn = MATERIAL_NODES[node.name]
        outs = fn(ctx, *[_resolve(d, params, vars_, None)
                         for d in node.inputs])
        for key, val in zip(node.outputs, outs):
            vars_[key] = val

    def bind(key) -> Vec3:
        if isinstance(key, int) and key == -1:
            return zero
        return vars_.get(key, zero)

    return ShaderOut(*(bind(k) for k in mat.bindings))


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


def loads_scene(text: str, env_image: Optional[np.ndarray] = None,
                env_sh: Optional[np.ndarray] = None,
                env_filter: str = "linear",
                env_gather: str = "exact") -> Scene:
    """Parse a `.scene` JSON string (either format generation).

    `env_image`: an (H, W, 3) equirect texture sky (`Graphics.cpp:287`).
    `env_sh`: (16, 3) l <= 3 spherical-harmonic sky coefficients; an
    `environment.sh` array in the scene does the same.  The texture wins
    when both are given."""
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
    has_env = env_image is not None
    if has_env:
        env_params["image"] = np.asarray(env_image, np.float32)
    if env_sh is None and "sh" in env:
        env_sh = np.asarray(env["sh"], np.float32)
    has_sh = env_sh is not None and not has_env
    if has_sh:
        sh = np.asarray(env_sh, np.float32)
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
                 has_env_map=has_env, has_sh_env=has_sh,
                 env_filter=env_filter, env_gather=env_gather,
                 spectral_rows=spec_rows, _init=init)


def load_scene(path: str, env_image: Optional[np.ndarray] = None,
               env_sh: Optional[np.ndarray] = None,
               env_filter: str = "linear",
               env_gather: str = "exact") -> Scene:
    with open(path) as f:
        return loads_scene(f.read(), env_image, env_sh=env_sh,
                           env_filter=env_filter, env_gather=env_gather)
