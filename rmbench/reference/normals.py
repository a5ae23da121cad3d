"""SDF-gradient normals: a frozen copy of the port's
`render/integrator.py::get_normal` for 4 and 6 taps (the configurations
run 4; the exact normal of `normal_taps=0` is not copied)."""
from __future__ import annotations

from rmbench.reference.config import RenderConfig
from rmbench.reference.graph import Scene
from rmbench.reference.vecmath import Vec3

_TETRA = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
          (1.0, 1.0, 1.0))


def get_normal(scene: Scene, params, cfg: RenderConfig, p: Vec3) -> Vec3:
    """`normal_taps=6`: central differences (`RayMarch.glsl:259-268`,
    eps = cfg.normal_eps); `normal_taps=4`: tetrahedron differences."""
    e = cfg.normal_eps

    def md(q):
        return scene.map_dist(params, q, cfg.max_dist)

    if cfg.normal_taps not in (4, 6):
        raise ValueError("the reference has the 4- and 6-tap normals only")
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
