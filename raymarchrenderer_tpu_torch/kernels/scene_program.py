"""Compile a `Scene` into the flat buffers the CUDA kernels interpret.

Every kernel shares the object program (`csrc/scene_map.cuh`), and each
appends its own tail:

    int32:   [n_objects, tail_int_offset, tail_float_offset, n_regs]  header
             [first_word, n_nodes, distance_word, mat_index] * n_objects
             [opcode | marks, out_reg, in0, in1, in2, in3] * object nodes
             tail ints
    float32: object parameters (a vec3 each), then tail floats

An object input word is a register (>= 0), the sample point (-1), or a
parameter vec3 at float offset `-word - 2` (a scalar parameter is stored
splatted, which is what `_param_to_vec3` does).  Every node that writes
gets a register of its own, so `n_regs` (the most nodes one object writes)
registers hold every node's value, which the exact normal's reverse sweep
reads.  The forwarding marks let the interpreter keep a value in registers
instead: above the opcode, bit `FWD_IN << k` says that input k reads the
node just before (its register word stays, for the reverse sweep), bit
`FWD_OUT` that nothing but the next node or the object's distance reads
the node's value (it is never stored), and `FWD_DIST` in an object's
distance word (above the register) that the distance is the last node's
value.  The stored values need `stored_slots` register slots per thread
(1 + the largest register a stored value takes, 0 when every value is
forwarded).  The kernels stage both buffers in shared memory with every
thread's register slots after them (`shared_bytes`), so neither the node
count nor the light count has a cap of its own.

`csrc/march_fused.cu` reads the object program alone (no tail), as the
JAX package's `march_fused` ships only `params["objects"]`.

Spectral tail (`csrc/mega_spectral.cu`): ints [n_mats, kind * n_mats];
floats [min_wave * n_mats, max_wave * n_mats, power * n_mats].

RGB tail (`csrc/mega_paths.cu`): ints [n_mats, n_lights, then per material
(first_word, n_instr, rng_base, color, dir, inside, hit), then the material
instructions, 12 words each: [opcode, out0..out3, in0..in6]]; floats
[sky_power, light pos * 3L, power * L, radius * L, the SH sky's 48
coefficients (k-major, (16, 3); SH scenes only), material parameters].
The kind of sky (constant, SH, or deferred for an env image, `sky_kind`)
is an argument of the entry points, which pick the kernel's sky policy
from it; the env image itself never enters the kernel (the recorder reads
no sky either).
A material input word is a register (>= 0), zero (-1) or a parameter vec3
(`-word - 2`, absolute in the float buffer); an output word is a register
or -1 (not bound); a binding is a register or -1 (zero).  `rng_base` is the
draw counter before the material's first draw: `Scene.shade` evaluates
every material graph with one stream, so material i draws after the draws
of materials 0..i-1.

The layout is static per `Scene`: the int32 program with its header's
offsets filled in and each kernel's static tail ints, with `stored_slots`,
`n_regs` and the data order of the parameters.  Each of `object_buffers`,
`spectral_buffers` and `paths_buffers` compiles it and uploads it to a
device once, at its first call for that scene and device, and keeps it
with the scene (`Scene._layouts`); every call gathers the values from the
tensors on the device (object and material parameters, the band table,
the sky, the lights), so after a scene's first call no build copies from
the host to the card.  Every call runs in the profiler span
`rmr.scene_buffers`, the once-only compile and upload in
`rmr.scene_compile` inside the first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from raymarchrenderer_tpu_torch.scene.graph import (_NODE, _PARAM, _POINT,
                                                    _VAR, Scene)
from raymarchrenderer_tpu_torch.utils.profiling import span

# opcode and arity of each object node, in the kernels' `Op` order
OPCODES = {
    "map_sphere": (0, 3), "map_box": (1, 3), "map_plane": (2, 3),
    "map_torus": (3, 3), "map_cylinder": (4, 3), "map_capsule": (5, 4),
    "op_union": (6, 2), "op_subtract": (7, 2), "op_intersect": (8, 2),
    "op_smooth_union": (9, 3), "domain_repeat": (10, 2),
    "misc_getX": (11, 1), "misc_getY": (12, 1), "misc_getZ": (13, 1),
    "math_add": (14, 2), "math_subtract": (15, 2), "math_multiply": (16, 2),
    "math_divide": (17, 2), "math_sine": (18, 1), "math_cosine": (19, 1),
}
# the forwarding marks (kFwdIn, kFwdOut, kFwdDist in csrc/scene_map.cuh)
FWD_IN, FWD_OUT, FWD_DIST = 1 << 8, 1 << 12, 1 << 16
# FP32 operations of each object node as csrc/scene_map.cuh evaluates it,
# counting an add, multiply, divide, min, max, abs, fmod, sqrt, sin or cos
# as one (for the kernels' operation bound, `map_flops`)
NODE_FLOPS = {
    "map_sphere": 11, "map_box": 23, "map_plane": 17, "map_torus": 13,
    "map_cylinder": 19, "map_capsule": 34, "op_union": 3, "op_subtract": 3,
    "op_intersect": 3, "op_smooth_union": 13, "domain_repeat": 12,
    "misc_getX": 0, "misc_getY": 0, "misc_getZ": 0, "math_add": 3,
    "math_subtract": 3, "math_multiply": 3, "math_divide": 3,
    "math_sine": 3, "math_cosine": 3,
}
_HEADER, _OBJ_WORDS, _NODE_WORDS = 4, 4, 6

# material nodes, in mega_paths.cu's `MatOp` order: name -> (opcode,
# accepted input counts, registers written, random draws)
MAT_OPCODES = {
    "shader_diffuse": (0, (1,), 2, 2),
    "shader_glossy": (1, (2,), 2, 2),
    "shader_refraction": (2, (2, 3), 3, 2),
    "shader_volumeScatter": (3, (2,), 4, 4),
    "shader_emission": (4, (2,), 1, 0),
    "shader_mix": (5, (5, 7), None, 1),      # 3 outputs (7 inputs) or 2
    "misc_facing": (6, (0,), 1, 0),
    "misc_inside": (7, (0,), 1, 0),
    "misc_fresnel": (8, (0,), 1, 0),
    "math_add": (9, (2,), 1, 0),
    "math_subtract": (10, (2,), 1, 0),
    "math_multiply": (11, (2,), 1, 0),
    "math_divide": (12, (2,), 1, 0),
    "math_sine": (13, (1,), 1, 0),
    "math_cosine": (14, (1,), 1, 0),
}
# the gen-2 shaders of the new scene format write a 4-register bundle
# (color, dir, inside, hit)
NEW_FMT_OPCODES = {"shader_diffuse": (15, 1, 2), "shader_glossy": (16, 2, 2),
                   "shader_mix": (17, 3, 1)}
MAX_MAT_REGS = 32      # kMaxMatRegs in csrc/paths_shade.cuh
BLOCK_THREADS = 128    # kBlockThreads in csrc/scene_map.cuh
_MAT_WORDS, _INSTR_WORDS, _ZERO = 7, 12, -1


def compile_program(scene: Scene):
    """(int32 word list of the object program, list of (object, param
    index) in data order)."""
    n_obj = len(scene.objects)
    words = [n_obj, 0, 0, 0]
    obj_words, node_words, param_slots = [], [], []
    first = _HEADER + _OBJ_WORDS * n_obj
    n_regs = 0
    for oi, obj in enumerate(scene.objects):
        regs, n_written = {}, 0
        start = first + len(node_words)
        ins_of, outs = [], []
        for node in obj.nodes:
            if node.name not in OPCODES:
                raise KeyError(f"unknown object node {node.name!r}")
            op, arity = OPCODES[node.name]
            if len(node.inputs) != arity:
                raise ValueError(f"{node.name} takes {arity} inputs, "
                                 f"got {len(node.inputs)}")
            ins = []
            for desc in node.inputs:
                if desc[0] == _POINT:
                    ins.append(-1)
                elif desc[0] == _PARAM:
                    ins.append(-(3 * len(param_slots)) - 2)
                    param_slots.append((oi, desc[1]))
                elif desc[0] == _VAR:
                    if desc[1] not in regs:
                        raise KeyError(f"object {oi}: register {desc[1]!r} "
                                       "read before it is written")
                    ins.append(regs[desc[1]])
                else:
                    raise ValueError(f"unresolvable input {desc}")
            out = -1
            if node.outputs:
                # a register of its own per node (a rebound key reads
                # the new one), so the exact normal's reverse sweep finds
                # every node's inputs in the registers
                out = n_written
                n_written += 1
                regs[node.outputs[0]] = out
            ins_of.append(ins)
            outs.append((op, out))
        if obj.distance not in regs:
            raise KeyError(f"object {oi}: distance register "
                           f"{obj.distance!r} is never written")
        dist = regs[obj.distance]
        marks = _forwarding(ins_of, [o for _, o in outs], dist)
        for (op, out), ins, m in zip(outs, ins_of, marks[0]):
            node_words += [op | m, out] + ins + [-1] * (4 - len(ins))
        obj_words += [start, len(obj.nodes), dist | marks[1],
                      scene.mat_index(obj.mat_id)]
        n_regs = max(n_regs, n_written)
    words[3] = n_regs
    words += obj_words + node_words
    return words, param_slots


def _forwarding(ins_of, outs, dist):
    """The forwarding marks of one object: (each node's marks, the
    distance word's mark).  Input k of node i is forwarded when it reads
    node i - 1's register; node i's value is not stored when only node
    i + 1 reads it and it is the distance only as the last node."""
    n = len(outs)
    marks = []
    for i in range(n):
        m = 0
        prev = outs[i - 1] if i else -1
        for k, code in enumerate(ins_of[i]):
            if prev >= 0 and code == prev:
                m |= FWD_IN << k
        out = outs[i]
        if out >= 0:
            later = any(out in ins for ins in ins_of[i + 2:])
            if not later and (out != dist or i == n - 1):
                m |= FWD_OUT
        marks.append(m)
    last = outs[-1] if outs else -1
    return marks, (FWD_DIST if n and dist == last else 0)


def stored_slots(words) -> int:
    """Register slots the stencil interpreter stores into for the program
    `words` (1 + the largest register of a value that is not forwarded;
    0 when every value is)."""
    n_obj = words[0]
    slots = 0
    for i in range(n_obj):
        first, n_nodes = words[_HEADER + _OBJ_WORDS * i:
                               _HEADER + _OBJ_WORDS * i + 2]
        for k in range(n_nodes):
            w, out = words[first + _NODE_WORDS * k:
                           first + _NODE_WORDS * k + 2]
            if out >= 0 and not w & FWD_OUT:
                slots = max(slots, out + 1)
    return slots


def shared_bytes(dims, exact: bool) -> int:
    """Dynamic shared memory of one block (csrc/scene_map.cuh
    `scene_smem_bytes`): the program words and data floats, then every
    thread's register slots: 3 floats per stored slot, or, with the exact
    normal, 3 value, 3 adjoint and 1 live word per register."""
    n_words, n_floats, stored, n_regs = dims
    per_thread = 7 * n_regs if exact else 3 * stored
    return 4 * (n_words + n_floats + BLOCK_THREADS * per_thread)


def map_flops(scene: Scene) -> int:
    """FP32 operations of one `map_dist` evaluation of the kernels: every
    object's nodes and the running minimum over the objects."""
    return (sum(NODE_FLOPS[n.name] for o in scene.objects for n in o.nodes)
            + max(len(scene.objects) - 1, 0))


def _vec3(a: torch.Tensor, device, what: str) -> torch.Tensor:
    a = a.to(device=device, dtype=torch.float32)
    if a.ndim != 0 and a.numel() < 3:
        raise ValueError(f"{what} has shape {tuple(a.shape)}; a vec3 or a "
                         "scalar is needed")
    return a.expand(3) if a.ndim == 0 else a.reshape(-1)[:3]


class _Layout(NamedTuple):
    """A scene's compiled layout on one device: the int32 program (header,
    object table and nodes, then the kernel's static tail ints), the object
    and material parameters in data order, and the `SceneDims` fields that
    come from the program."""
    prog: torch.Tensor
    slots: tuple
    mat_slots: tuple
    stored: int
    n_regs: int


def _kept(scene: Scene, key, device, compile_layout) -> _Layout:
    """The layout `key` of `scene` on `device` (`cuda` and `cuda:0` are one
    key): at its first use `compile_layout()` gives the object program
    `(words, param slots)`, the kernel's static tail ints and the material
    parameters, and the program, its header's tail offsets filled in, is
    uploaded in the span `rmr.scene_compile`, then kept with the scene.
    `torch.tensor(..., device=)` is a blocking copy: the program is on the
    device when it returns, so launches on any stream may read it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    layout = scene._layouts.get((key, device))
    if layout is None:
        with span("rmr.scene_compile"):
            (words, slots), tail_ints, mat_slots = compile_layout()
            words = list(words)
            words[1] = len(words)                   # tail ints' offset
            words[2] = 3 * len(slots)               # tail floats' offset
            prog = torch.tensor(words + tail_ints, dtype=torch.int32,
                                device=device)
            layout = scene._layouts[(key, device)] = _Layout(
                prog, tuple(slots), tuple(mat_slots), stored_slots(words),
                words[3])
    return layout


def _assemble(layout: _Layout, prog, params, device, tail_floats):
    """The buffers of one launch: `prog` (the kept program, or it with a
    launch's tail ints), the data (the object parameters gathered on
    `device`, then `tail_floats`, 1-D float32 tensors, then the material
    parameters), and the buffers' sizes `(n_words, n_floats, stored
    slots, n_regs)`, the kernels' `SceneDims`."""
    vecs = [_vec3(params["objects"][oi][pi], device,
                  f"object {oi} parameter {pi}") for oi, pi in layout.slots]
    mats = [_vec3(params["materials"][mi][pi], device,
                  f"material {mi} parameter {pi}")
            for mi, pi in layout.mat_slots]
    data = torch.cat(vecs + list(tail_floats) + mats + [
        torch.zeros(0, dtype=torch.float32, device=device)])
    dims = (int(prog.numel()), int(data.numel()), layout.stored,
            layout.n_regs)
    return prog, data, dims


def object_buffers(scene: Scene, params, device):
    """(int32 program, float32 data, dims) of `csrc/march_fused.cu`: the
    object program and the object parameters, no tail."""
    with span("rmr.scene_buffers"):
        layout = _kept(scene, "objects", device,
                       lambda: (compile_program(scene), [], ()))
        return _assemble(layout, layout.prog, params, device, [])


def spectral_buffers(scene: Scene, params, mats, device):
    """(int32 program, float32 data, dims) of `csrc/mega_spectral.cu`, the
    band table `mats` (`SpectralMaterials`) as the tail: its kinds
    appended on the device to the kept program, its rows to the data."""
    n_mats = int(mats.min_wave.shape[0])
    if scene.objects and n_mats == 0:
        raise ValueError("the band table has no rows")
    with span("rmr.scene_buffers"):
        layout = _kept(scene, ("spectral", n_mats), device,
                       lambda: (compile_program(scene), [n_mats], ()))
        prog = torch.cat([layout.prog,
                          mats.kind.to(device=device, dtype=torch.int32)])
        band = [b.to(device=device, dtype=torch.float32)
                for b in (mats.min_wave, mats.max_wave, mats.power)]
        return _assemble(layout, prog, params, device, band)


def _material_code(mat, base_float: int, n_floats: int):
    """(instruction words, bindings, draws, param indices in data order)
    of one material; parameter codes are absolute float offsets from
    `base_float` + 3 per parameter already placed (`n_floats`)."""
    words, slots = [], []
    regs = {}

    def param(pi):
        slots.append(pi)
        return -(base_float + n_floats + 3 * (len(slots) - 1)) - 2

    def reg(key):
        """The register of `key`, allocated at its first write."""
        if key not in regs:
            if len(regs) >= MAX_MAT_REGS:
                raise ValueError(f"material {mat.mat_id} needs more than "
                                 f"{MAX_MAT_REGS} registers")
            regs[key] = len(regs)
        return regs[key]

    def emit(op, outs, ins):
        words.extend([op] + list(outs) + [-1] * (4 - len(outs))
                     + list(ins) + [_ZERO] * (7 - len(ins)))

    draws = 0
    if mat.fmt == "new":
        out_regs = {}            # node index -> (first register, width)

        def ev(ni):
            nonlocal draws
            if ni in out_regs:
                return out_regs[ni]
            node = mat.nodes[ni]
            ins = []
            for d in node.inputs:
                if d[0] == _PARAM:
                    ins.append((param(d[1]), 1))
                elif d[0] == _NODE:
                    ins.append(ev(d[1]))
                else:
                    raise ValueError(f"unresolvable input {d}")
            if node.name == "misc_fresnel":
                r = reg(ni)
                emit(MAT_OPCODES["misc_fresnel"][0], [r], [])
                out_regs[ni] = (r, 1)
                return out_regs[ni]
            if node.name not in NEW_FMT_OPCODES:
                raise KeyError(f"unknown new-format node {node.name}")
            op, arity, n_draws = NEW_FMT_OPCODES[node.name]
            if len(ins) != arity:
                raise ValueError(f"{node.name} takes {arity} inputs")
            bundles = ins[:2] if node.name == "shader_mix" else []
            vecs = ins[2:] if node.name == "shader_mix" else ins
            if any(w != 4 for _, w in bundles) or any(w != 1 for _, w in vecs):
                raise ValueError(f"material {mat.mat_id}: {node.name} "
                                 "input of the wrong kind")
            out = [reg((ni, j)) for j in range(4)]     # consecutive
            emit(op, out, [c for c, _ in ins])
            draws += n_draws
            out_regs[ni] = (out[0], 4)
            return out_regs[ni]

        first, width = ev(mat.output)
        if width != 4:
            raise ValueError("new-format material output node must be a "
                             "shader")
        return words, [first, first + 1, first + 2, first + 3], draws, slots

    for node in mat.nodes:
        if node.name not in MAT_OPCODES:
            raise KeyError(f"unknown material node {node.name!r}")
        op, arities, n_out, n_draws = MAT_OPCODES[node.name]
        if len(node.inputs) not in arities:
            raise ValueError(f"{node.name} takes {arities} inputs, got "
                             f"{len(node.inputs)}")
        ins = []
        for d in node.inputs:
            if d[0] == _PARAM:
                ins.append(param(d[1]))
            elif d[0] == _VAR:
                if d[1] not in regs:
                    raise KeyError(f"material {mat.mat_id}: register "
                                   f"{d[1]!r} read before it is written")
                ins.append(regs[d[1]])
            else:
                raise ValueError(f"unresolvable input {d}")
        if node.name == "shader_mix":
            n_out = 3 if len(ins) == 7 else 2
            if len(ins) == 5:       # (c1, d1, c2, d2, f): zero insides
                ins = [ins[0], ins[1], _ZERO, ins[2], ins[3], _ZERO, ins[4]]
        emit(op, [reg(key) for key in node.outputs[:n_out]], ins)
        draws += n_draws
    binds = [-1 if (isinstance(k, int) and k == -1) else regs.get(k, -1)
             for k in mat.bindings]
    return words, binds, draws, slots


def material_program(scene: Scene, base_float: int):
    """(tail int words after [n_mats, n_lights], the material parameters
    as (material, param index) in data order, each material's rng_base)."""
    table, instrs, slots, bases = [], [], [], []
    draws = 0
    for mi, mat in enumerate(scene.materials):
        w, binds, n_draws, mslots = _material_code(mat, base_float,
                                                   3 * len(slots))
        table += [len(instrs), len(w) // _INSTR_WORDS, draws] + binds
        bases.append(draws + 1)
        instrs += w
        slots += [(mi, pi) for pi in mslots]
        draws += n_draws
    return table, instrs, slots, bases


def rng_bases(scene: Scene):
    """The slot of each material's first draw in `Scene.shade`'s stream."""
    return material_program(scene, 0)[3]


SKY_CONST, SKY_SH, SKY_DEFER = 0, 1, 2   # the kernels' kSky* (paths_shade.cuh)
N_SH_FLOATS = 48


def sky_kind(scene: Scene) -> int:
    """The RGB kernels' sky policy of `scene`."""
    if scene.has_env_map:
        return SKY_DEFER
    return SKY_SH if scene.has_sh_env else SKY_CONST


def _paths_layout(scene: Scene):
    """The layout of `paths_buffers` (`_kept`): the material table's first
    instruction words absolute, the material parameters' codes after the
    object parameters and the head of floats (the sky power, the light
    table, the SH coefficients)."""
    program = compile_program(scene)
    n_head = 1 + 5 * scene.n_lights + (
        N_SH_FLOATS if sky_kind(scene) == SKY_SH else 0)
    table, instrs, mat_slots, _ = material_program(
        scene, 3 * len(program[1]) + n_head)
    n_mats = len(scene.materials)
    instr0 = len(program[0]) + 2 + len(table)     # absolute first word
    for m in range(n_mats):
        table[_MAT_WORDS * m] += instr0
    return program, [n_mats, scene.n_lights] + table + instrs, mat_slots


def paths_buffers(scene: Scene, params, device):
    """(int32 program, float32 data, dims) of `csrc/mega_paths.cu` and
    `csrc/wavefront_paths.cu`: the material program, the light table, the
    sky power and, for an SH sky, its coefficients as the tail (the
    kernels read the lights only with NEE)."""
    with span("rmr.scene_buffers"):
        n_lights = scene.n_lights
        lights = params["lights"]
        head = [params["env"]["power"].to(device=device,
                                          dtype=torch.float32).reshape(1)]
        if n_lights:
            pos = lights["pos"].to(device=device, dtype=torch.float32)
            if tuple(pos.shape) != (n_lights, 3):
                raise ValueError(
                    f"light positions have shape {tuple(pos.shape)}")
            head.append(pos.reshape(-1))
            for k in ("power", "radius"):
                v = lights[k].to(device=device, dtype=torch.float32)
                if v.numel() != n_lights:
                    raise ValueError(f"light {k} has shape "
                                     f"{tuple(v.shape)}")
                head.append(v.reshape(-1))
        if sky_kind(scene) == SKY_SH:
            sh = params["env"]["sh"].to(device=device, dtype=torch.float32)
            if tuple(sh.shape) != (16, 3):
                raise ValueError(
                    f"SH coefficients have shape {tuple(sh.shape)}")
            head.append(sh.reshape(-1))
        layout = _kept(scene, "paths", device,
                       lambda: _paths_layout(scene))
        return _assemble(layout, layout.prog, params, device, head)
