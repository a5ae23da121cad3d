"""SDF-gradient normals (the JAX package's `render/integrator.get_normal`).

The wavefront RGB integrator (`trace_rgb`, `march`) is a later slice; the
megakernels need only the normal.
"""
from __future__ import annotations

from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.scene.graph import Scene

_TETRA = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
          (1.0, 1.0, 1.0))


def get_normal(scene: Scene, params, cfg: RenderConfig, p: Vec3) -> Vec3:
    """`normal_taps=6`: central differences (`RayMarch.glsl:259-268`,
    eps = cfg.normal_eps); `normal_taps=4`: tetrahedron differences.
    `normal_taps=0` (the exact gradient by one reverse sweep) is not ported
    yet."""
    e = cfg.normal_eps

    def md(q):
        return scene.map_dist(params, q, cfg.max_dist)

    if cfg.normal_taps == 0:
        raise NotImplementedError(
            "normal_taps=0 (exact autodiff gradient) is not ported yet")
    if cfg.normal_taps == 4:
        n = Vec3(0.0, 0.0, 0.0)
        for kx, ky, kz in _TETRA:
            k = Vec3(kx, ky, kz)
            n = n + k * md(p + k * e)
        return n.normalized()
    return Vec3(md(Vec3(p.x + e, p.y, p.z)) - md(Vec3(p.x - e, p.y, p.z)),
                md(Vec3(p.x, p.y + e, p.z)) - md(Vec3(p.x, p.y - e, p.z)),
                md(Vec3(p.x, p.y, p.z + e)) - md(Vec3(p.x, p.y, p.z - e))
                ).normalized()
