"""Compile a `Scene` and its band table into the flat buffers the CUDA
spectral megakernel interprets (`csrc/mega_spectral.cu`).

int32 program:

    [n_objects, n_mats, band_offset, kind_offset]          header
    [first_word, n_nodes, distance_reg, mat_index] * n_objects
    [opcode, out_reg, in0, in1, in2, in3] * total nodes
    [kind] * n_mats

An input word is a register (>= 0), the sample point (-1), or a parameter
vec3 at float offset `-word - 2` of the float32 data buffer (a scalar
parameter is stored splatted, which is what `_param_to_vec3` does).  The
data buffer holds the object parameters followed by the band table's
min_wave, max_wave and power rows.

The layout is static per `Scene`; the parameter values are gathered from
the tensors on the device, so nothing leaves the card.
"""
from __future__ import annotations

import torch

from raymarchrenderer_tpu_torch.render.spectral_integrator import (
    SpectralMaterials)
from raymarchrenderer_tpu_torch.scene.graph import (_PARAM, _POINT, _VAR,
                                                    Scene)

# opcode and arity of each object node, in the kernel's `Op` order
OPCODES = {
    "map_sphere": (0, 3), "map_box": (1, 3), "map_plane": (2, 3),
    "map_torus": (3, 3), "map_cylinder": (4, 3), "map_capsule": (5, 4),
    "op_union": (6, 2), "op_subtract": (7, 2), "op_intersect": (8, 2),
    "op_smooth_union": (9, 3), "domain_repeat": (10, 2),
    "misc_getX": (11, 1), "misc_getY": (12, 1), "misc_getZ": (13, 1),
    "math_add": (14, 2), "math_subtract": (15, 2), "math_multiply": (16, 2),
    "math_divide": (17, 2), "math_sine": (18, 1), "math_cosine": (19, 1),
}
MAX_REGS = 16          # kMaxRegs in the kernel
_HEADER, _OBJ_WORDS, _NODE_WORDS = 4, 4, 6


def compile_program(scene: Scene, n_mats: int):
    """(int32 word list, list of (object, param index) in data order)."""
    n_obj = len(scene.objects)
    words = [n_obj, n_mats, 0, 0]
    obj_words, node_words, param_slots = [], [], []
    first = _HEADER + _OBJ_WORDS * n_obj
    for oi, obj in enumerate(scene.objects):
        regs = {}
        start = first + len(node_words)
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
                key = node.outputs[0]
                out = regs.setdefault(key, len(regs))
                if out >= MAX_REGS:
                    raise ValueError(f"object {oi} needs more than "
                                     f"{MAX_REGS} registers")
            node_words += [op, out] + ins + [-1] * (4 - len(ins))
        if obj.distance not in regs:
            raise KeyError(f"object {oi}: distance register "
                           f"{obj.distance!r} is never written")
        obj_words += [start, len(obj.nodes), regs[obj.distance],
                      scene.mat_index(obj.mat_id)]
    words += obj_words + node_words
    return words, param_slots


def scene_buffers(scene: Scene, params, mats: SpectralMaterials, device):
    """(int32 program tensor, float32 data tensor) on `device`."""
    n_mats = int(mats.min_wave.shape[0])
    if scene.objects and n_mats == 0:
        raise ValueError("the band table has no rows")
    words, slots = compile_program(scene, n_mats)
    vecs = []
    for oi, pi in slots:
        a = params["objects"][oi][pi].to(device=device, dtype=torch.float32)
        if a.ndim != 0 and a.numel() < 3:
            raise ValueError(f"object {oi} parameter {pi} has shape "
                             f"{tuple(a.shape)}; a vec3 or a scalar is needed")
        vecs.append(a.expand(3) if a.ndim == 0 else a.reshape(-1)[:3])
    band = [mats.min_wave, mats.max_wave, mats.power]
    data = torch.cat(vecs + [b.to(device=device, dtype=torch.float32)
                             for b in band])
    words[2] = 3 * len(vecs)                 # band rows' float offset
    words[3] = len(words)                    # kinds' int offset
    prog = torch.tensor(words, dtype=torch.int32, device=device)
    kinds = mats.kind.to(device=device, dtype=torch.int32)
    return torch.cat([prog, kinds]).contiguous(), data.contiguous()
