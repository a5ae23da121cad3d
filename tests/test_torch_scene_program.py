"""The compiled object program of `kernels/scene_program.py` against the
plain map, on the CPU, without JAX and without a card.

The CUDA kernels interpret the program with forwarding marks: a node input
that reads the node just before takes its value from a register of the
interpreter, a value that only the next node (or, as the last node, the
object's distance) reads is never stored, and everything else lives in
register slots (`csrc/scene_map.cuh` `run_object`).  `eval_program` below
is that interpreter in Python: it reads only what the layout says, stores
only the values the marks do not forward, and calls the port's own node
functions, so a wrong mark, register or parameter offset reads a missing
slot or a wrong value.  Its distance and material index must equal the
plain `Scene.map_dist` and `Scene.map` bit for bit at seeded points of
every scene file and builtin scene.

A scene's layout (the program and the parameters' data order) is compiled
and kept at its first build on that scene and device; later builds
gather only the values, so a changed parameter must reach the data, and
no scene may read another's program.
"""
import glob
import os

import numpy as np
import pytest
import torch

from _torch_parity import (ALL_NODES_SCENE, BIG_OBJECT_SCENE,
                           many_lights_scene)

from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.kernels import scene_program as sp
from raymarchrenderer_tpu_torch.render.spectral_integrator import band_table
from raymarchrenderer_tpu_torch.scene import builtin, load_scene, loads_scene
from raymarchrenderer_tpu_torch.scene.graph import OBJECT_NODES

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCENE_FILES = sorted(glob.glob(os.path.join(_ROOT, "data", "scenes",
                                             "*.scene")))
_BUILTINS = ("sphere_on_floor", "single_sphere", "csg_demo", "cornell",
             "glass_demo", "volume_demo")
_NAMES = {op: name for name, (op, _) in sp.OPCODES.items()}
_ARITY = {op: arity for _, (op, arity) in sp.OPCODES.items()}
MAX_DIST = 100.0


def _scene(key):
    if key.endswith(".scene"):
        return load_scene(key)
    if key == "all_nodes":
        return loads_scene(ALL_NODES_SCENE)
    if key == "big_object":
        return loads_scene(BIG_OBJECT_SCENE)
    return getattr(builtin, key)()


_KEYS = [os.path.basename(f) for f in _SCENE_FILES] + list(_BUILTINS) + [
    "all_nodes", "big_object"]


def _key_path(key):
    return (os.path.join(_ROOT, "data", "scenes", key)
            if key.endswith(".scene") else key)


def eval_program(words, data, p: Vec3):
    """(distance, material index) at p of the compiled object program:
    the running minimum from object 0 (the kernels' map_dist) and the
    strict-< fold seeded with MAX_DIST / -1 (map_mid)."""
    n_obj = words[0]
    n_regs = words[3]

    def param(code):
        off = -code - 2
        return Vec3(data[off], data[off + 1], data[off + 2])

    def object_dist(i):
        first, n_nodes, dist_word, _ = words[4 + 4 * i: 8 + 4 * i]
        slots, prev = {}, None
        for k in range(n_nodes):
            w, out, *ins = words[first + 6 * k: first + 6 * k + 6]
            op = w & 0xFF
            args = []
            for j in range(_ARITY[op]):
                code = ins[j]
                if w & (sp.FWD_IN << j):
                    assert code >= 0 and prev is not None
                    args.append(prev)
                elif code >= 0:
                    args.append(slots[code])     # never a forwarded value
                elif code == -1:
                    args.append(p)
                else:
                    args.append(param(code))
            prev = OBJECT_NODES[_NAMES[op]](*args)[0]
            assert out < n_regs
            if out >= 0 and not w & sp.FWD_OUT:
                assert out < sp.stored_slots(words)
                slots[out] = prev
        d = prev if dist_word & sp.FWD_DIST else slots[dist_word & 0xFFFF]
        return d.x.expand(p.x.shape)

    dist = [object_dist(i) for i in range(n_obj)]
    d = dist[0]
    for di in dist[1:]:
        d = torch.minimum(d, di)
    best = torch.full(p.x.shape, MAX_DIST, dtype=torch.float32)
    mid = torch.full(p.x.shape, -1, dtype=torch.int32)
    for i, di in enumerate(dist):
        take = di < best
        best = torch.where(take, di, best)
        mid = torch.where(take, words[4 + 4 * i + 3], mid)
    return d, mid


def _points(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-4.0, 4.0, (n, 3)),
                          rng.uniform(-1.0, 2.5, (n, 3))]).astype(np.float32)
    return Vec3(*(torch.from_numpy(pts[:, k].copy()) for k in range(3)))


@pytest.mark.parametrize("key", _KEYS)
def test_forwarded_program_matches_plain_map(key):
    """The forwarded program's distance and material index equal the plain
    map's, bit for bit, at seeded points."""
    scene = _scene(_key_path(key))
    params = scene.init_params("cpu")
    prog, data, _ = sp.object_buffers(scene, params, "cpu")
    words = prog.tolist()
    p = _points()
    d, mid = eval_program(words, data, p)
    want_d = scene.map_dist(params, p, MAX_DIST)
    _, want_mid = scene.map(params, p, MAX_DIST)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(mid, want_mid)


@pytest.mark.parametrize("key", _KEYS)
def test_every_node_keeps_its_register(key):
    """The exact normal's reverse sweep reads every node's inputs from the
    registers: each node that writes has a register of its own below
    n_regs, a forwarded input still names its register, and the distance
    word names the distance's register."""
    scene = _scene(_key_path(key))
    words = sp.compile_program(scene)[0]
    for i in range(words[0]):
        first, n_nodes, dist_word, _ = words[4 + 4 * i: 8 + 4 * i]
        outs = [words[first + 6 * k + 1] for k in range(n_nodes)]
        written = [o for o in outs if o >= 0]
        assert written == list(range(len(written)))
        assert len(written) <= words[3]
        for k in range(n_nodes):
            w, _, *ins = words[first + 6 * k: first + 6 * k + 6]
            for j in range(4):
                if w & (sp.FWD_IN << j):
                    assert ins[j] == outs[k - 1] >= 0
        assert (dist_word & 0xFFFF) in written
        if dist_word & sp.FWD_DIST:
            assert dist_word & 0xFFFF == outs[-1]


def test_one_node_objects_store_nothing():
    """Every object of sphere_on_floor is one node: its value is the
    distance, forwarded, and the stencil interpreter needs no slot."""
    scene = builtin.sphere_on_floor()
    words = sp.compile_program(scene)[0]
    assert sp.stored_slots(words) == 0
    for i in range(words[0]):
        first, n_nodes, dist_word, _ = words[4 + 4 * i: 8 + 4 * i]
        assert n_nodes == 1 and dist_word & sp.FWD_DIST
        assert words[first] & sp.FWD_OUT


def test_object_test_marks():
    """object_test.scene: box, sphere, subtract (the box is read two nodes
    later: stored; the sphere feeds the subtract: forwarded), then a
    repeat feeding a sphere."""
    scene = load_scene(os.path.join(_ROOT, "data", "scenes",
                                    "object_test.scene"))
    words = sp.compile_program(scene)[0]
    first = words[4]
    marks = [words[first + 6 * k] & ~0xFF for k in range(3)]
    assert marks == [0, sp.FWD_OUT, (sp.FWD_IN << 1) | sp.FWD_OUT]
    assert words[6] == 2 | sp.FWD_DIST
    assert sp.stored_slots(words) == 1 and words[3] == 3


def test_big_object_compiles():
    """A 40-node object compiles (the 16-register cap is gone): 40
    registers, and the stencil interpreter's stored slots and the block's
    shared memory come from the program."""
    scene = loads_scene(BIG_OBJECT_SCENE)
    params = scene.init_params("cpu")
    prog, data, dims = sp.paths_buffers(scene, params, "cpu")
    assert dims[3] == 40 and 0 < dims[2] < 40
    assert dims[:2] == (prog.numel(), data.numel())
    stencil = sp.shared_bytes(dims, exact=False)
    exact = sp.shared_bytes(dims, exact=True)
    assert stencil == 4 * (dims[0] + dims[1] + 128 * 3 * dims[2])
    assert exact == 4 * (dims[0] + dims[1] + 128 * 7 * 40)
    assert exact < 232448          # fits an H100 block


def test_many_lights_compile():
    """A 12-light scene compiles for the RGB kernels with every light in
    the tail (the 8-light cap is gone): [sky, pos * 3L, power * L,
    radius * L] after the object parameters."""
    scene = many_lights_scene(12)
    params = scene.init_params("cpu")
    prog, data, dims = sp.paths_buffers(scene, params, "cpu")
    words = prog.tolist()
    assert words[words[1] + 1] == 12
    tail = data[words[2]:]
    lights = params["lights"]
    assert torch.equal(tail[1:37], lights["pos"].reshape(-1))
    assert torch.equal(tail[37:49], lights["power"].reshape(-1))
    assert torch.equal(tail[49:61], lights["radius"].reshape(-1))
    assert sp.shared_bytes(dims, exact=False) == 4 * (dims[0] + dims[1])


def _same(a, b) -> bool:
    """Byte for byte: the same dtype, shape and bits."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.detach().numpy().tobytes() == b.detach().numpy().tobytes())


# buffer kind -> (scene factory, its build on (scene, params, band table))
_BUILDS = {
    "paths_csg": (builtin.csg_demo,
                  lambda s, p, m: sp.paths_buffers(s, p, "cpu")),
    "paths_sof": (builtin.sphere_on_floor,
                  lambda s, p, m: sp.paths_buffers(s, p, "cpu")),
    "spectral": (builtin.sphere_on_floor,
                 lambda s, p, m: sp.spectral_buffers(s, p, m, "cpu")),
    "objects": (builtin.sphere_on_floor,
                lambda s, p, m: sp.object_buffers(s, p, "cpu")),
}


@pytest.mark.parametrize("build", list(_BUILDS))
def test_kept_layout_takes_changed_values(build):
    """A parameter leaf changed in place between two builds on one scene
    reaches the data, while the program and dims stay; each build equals,
    byte for byte, a build on a freshly parsed scene with the same
    values."""
    make, fn = _BUILDS[build]
    scene = make()
    params = scene.init_params("cpu")
    mats = band_table(scene, "cpu")
    got, want = [], []
    for step in range(2):
        if step:
            with torch.no_grad():
                params["objects"][0][0].add_(0.5)
                mats.power.mul_(0.5)
        got.append(fn(scene, params, mats))
        want.append(fn(make(), params, mats))
    assert _same(got[0][0], got[1][0]) and got[0][2] == got[1][2]
    assert not _same(got[0][1], got[1][1])
    for g, w in zip(got, want):
        assert _same(g[0], w[0]) and _same(g[1], w[1]) and g[2] == w[2]


def test_scenes_never_share_a_program():
    """Builds that alternate between two scenes give each its own program,
    equal to a fresh scene's; an equal scene parsed again keeps a layout
    of its own."""
    makes = (builtin.sphere_on_floor, builtin.csg_demo)
    for build in ("paths_csg", "spectral", "objects"):
        fn = _BUILDS[build][1]
        args = [(s, s.init_params("cpu"), band_table(s, "cpu"))
                for s in (make() for make in makes)]
        progs = [fn(*a)[0] for a in args + args]
        assert not _same(progs[0], progs[1])
        for k, make in enumerate(makes):
            fresh = make()
            assert fresh == args[k][0] and not fresh._layouts
            want = fn(fresh, *args[k][1:])[0]
            assert _same(progs[k], want) and _same(progs[k + 2], want)
            assert want.data_ptr() != progs[k].data_ptr()
