"""CLI frontend of the PyTorch port: `render --spectral`.

    python -m raymarchrenderer_tpu_torch render --spectral \\
        --scene data/scenes/spectral.scene --width 1024 --height 1024 \\
        --spp 128 --chunk 8 --relax 2.0 --normal-taps 4 --out out.png

The same flags as the JAX package's `render` subcommand that the spectral
path reads, plus `--device` (default `cuda`; `--device cpu` runs the plain
PyTorch version of the kernel).  On `cuda` with no card it fails.  The RGB
transport, checkpoints and the other subcommands are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _build_scene(args):
    from raymarchrenderer_tpu_torch.scene import builtin, load_scene
    if args.scene and os.path.exists(args.scene):
        return load_scene(args.scene)
    builtins_ = {
        "sphere_on_floor": builtin.sphere_on_floor,
        "single_sphere": builtin.single_sphere,
        "csg": builtin.csg_demo,
        "cornell": builtin.cornell,
        "glass": builtin.glass_demo,
        "volume": builtin.volume_demo,
    }
    if args.scene in builtins_:
        return builtins_[args.scene]()
    raise SystemExit(f"scene not found: {args.scene!r} "
                     f"(builtins: {', '.join(builtins_)})")


def _camera(args):
    from raymarchrenderer_tpu_torch.core.camera import Camera
    cam = Camera(aspect=args.width / args.height)
    if args.eye:
        cam.eye = tuple(args.eye)
    if args.look_at:
        cam.look_at(tuple(args.look_at))
    if args.fov:
        cam.fov = args.fov
    return cam


def _config(args):
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    return RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_steps=args.max_steps, max_bounces=args.max_bounces,
        max_dist=args.max_dist, seed=args.seed,
        relax_omega=args.relax or 0.0, normal_taps=args.normal_taps)


def _device(name: str):
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(use --device cpu for the plain PyTorch version)")
    return device


def _add_render_flags(p):
    p.add_argument("--scene", default="sphere_on_floor",
                   help="scene file path or builtin name")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--spp", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=512)
    p.add_argument("--max-bounces", type=int, default=16)
    p.add_argument("--max-dist", type=float, default=1000.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--spectral", action="store_true",
                   help="gen-3 wavelength transport (RayMarch3.glsl); the "
                        "only transport ported so far")
    p.add_argument("--relax", type=float, default=0.0,
                   help="over-relaxed sphere tracing omega (e.g. 2.0); "
                        "0 = reference-parity stepMultiply=0.5 march")
    p.add_argument("--normal-taps", type=int, choices=(0, 4, 6), default=6,
                   help="SDF normal estimator: 6 central-diff (parity), "
                        "4 tetrahedron (faster); 0 (exact gradient) is not "
                        "ported yet")
    p.add_argument("--chunk", type=int, default=8,
                   help="samples per kernel launch")
    p.add_argument("--out", default=None,
                   help="output image (.png/.bmp/.npy); default "
                        "output/<timestamp>.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (the CUDA kernel) or cpu (its plain PyTorch "
                        "version)")


def cmd_render(args):
    """Render, print the rate, save the image; returns (image, n, render
    seconds), the seconds from the first launch to the image on the host."""

    from raymarchrenderer_tpu_torch.io.image import save_image, timestamp_name
    from raymarchrenderer_tpu_torch.kernels.march import (
        prepare, render_progressive_fused_spectral)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)

    if not args.spectral:
        raise SystemExit("only the spectral transport is ported: pass "
                         "--spectral")
    device = _device(args.device)
    scene = _build_scene(args)
    params = scene.init_params(device)
    mats = band_table(scene, device)
    cfg = _config(args)
    corners = _camera(args).corner_rays_flat(device)
    build_s = prepare(device)       # nvcc stays out of the render time
    if build_s is not None:
        print(f"kernel built and loaded in {build_s:.3f}s")
    print(f"rendering {cfg.width}x{cfg.height} @ {cfg.spp} spp "
          f"(spectral, {device})")

    def progress(s, state):
        print(f"  {s}/{cfg.spp} spp", flush=True)

    t0 = time.perf_counter()
    img, n = render_progressive_fused_spectral(
        scene, params, mats, cfg, corners, spp=cfg.spp,
        samples_per_launch=args.chunk, callback=progress)
    img_np = img.cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0
    mpix_spp = cfg.width * cfg.height * n / 1e6
    print(f"done: {n:.0f} spp in {dt:.3f}s "
          f"({mpix_spp / max(dt, 1e-9):.2f} Mpix*spp/s)")
    out = args.out or os.path.join("output", timestamp_name("png"))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_image(out, img_np)
    print(f"saved {out}")
    return img, n, dt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raymarchrenderer_tpu_torch",
        description="sphere-tracing path tracer, PyTorch + CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to an image")
    _add_render_flags(pr)
    pr.set_defaults(fn=cmd_render)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
