"""Frozen render configuration.

Collects every tunable the reference scatters across GUI defaults and
hardcoded uniforms into one hashable dataclass (usable as a jit static arg):
  * maxDist=1000, maxSteps=512, maxBounces=16, stepMultiply=0.5 —
    `Graphics.cpp:326-329`
  * hit epsilon 0.001 (`RayMarch3.glsl:156`), normal epsilon 0.001
    (`:175-177`), surface offsets 0.002 outside / refraction offsets
    0.003/-0.002 (`RayMarch3.glsl:405`, `RayMarch.glsl:542-546`)
  * image 1024x1024, 128 spp, 4x4 tile grid — `GUI.cpp:201-208`, `GUI.h:38,40`
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1024
    height: int = 1024
    spp: int = 128
    max_dist: float = 1000.0
    max_steps: int = 512
    max_bounces: int = 16
    step_multiply: float = 0.5
    hit_eps: float = 1e-3
    normal_eps: float = 1e-3
    surface_offset: float = 2e-3
    exit_offset: float = 3e-3      # outside-offset after refraction exit
    inside_offset: float = 2e-3    # inward offset when entering a dielectric
    separate_channels: bool = False  # dispersion: trace R,G,B separately
    # Over-relaxed sphere tracing (Keinert et al. 2014, "Enhanced Sphere
    # Tracing" §3.1): march with step = dist·ω, ω ∈ (1, 2), accepting a step
    # only when consecutive unbounding spheres overlap (radius_i + radius_{i-1}
    # ≥ step) — otherwise back off and drop to ω=1 for the rest of the
    # segment.  Exact same hit set as the classic march for any 1-Lipschitz
    # (distance-underestimating) SDF, in ~2-3× fewer map evals than the
    # reference's ultra-conservative stepMultiply=0.5 (`Graphics.cpp:329`).
    # 0.0 disables (default — bitwise parity with the reference semantics);
    # scenes that warp space faster than 1-Lipschitz (scaled domains) should
    # keep it off, which is why the reference marches at 0.5 in the first
    # place.
    relax_omega: float = 0.0
    # SDF-gradient normal estimator: 6 = central differences (reference
    # parity, `RayMarch.glsl:259-268`); 4 = tetrahedron differences (same
    # O(ε²) accuracy, one third fewer map evals per shade).
    normal_taps: int = 6
    sky_power: float = 0.015       # RayMarch3.glsl:105 constant sky
    # Russian-roulette path termination — the gen-2 kernel's continuation
    # strategy (`RayMarch2.glsl:480-501`): from this bounce on, a path
    # survives with probability p = clip(max throughput component,
    # rr_min_prob, 1) and its throughput is divided by p (unbiased).
    # -1 disables (default — gen-1/gen-3 semantics trace every bounce).
    rr_start_bounce: int = -1
    rr_min_prob: float = 0.05
    seed: int = 0
    # tile grid: retained for scheduler parity / progressive preview chunking
    grid_width: int = 4
    grid_height: int = 4

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))


# The CPU-runnable BASELINE config 1: single sphere, 1 bounce, 256x256, 4 spp.
TINY = RenderConfig(width=256, height=256, spp=4, max_steps=128,
                    max_bounces=2, max_dist=100.0)
