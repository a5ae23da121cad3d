"""CLI frontend of the PyTorch port: `render`, RGB or `--spectral`, and
`train`, RGB or `--spectral` inverse rendering.

    python -m raymarchrenderer_tpu_torch render --scene csg --direct-light \\
        --width 1024 --height 1024 --spp 128 --chunk 128 --relax 2.0 \\
        --normal-taps 4 --out out.png
    python -m raymarchrenderer_tpu_torch render \\
        --scene data/scenes/default.scene --env-map sky.hdr --width 1024 \\
        --height 1024 --spp 128 --chunk 128 --relax 2.0 --normal-taps 4 \\
        --out env.png
    python -m raymarchrenderer_tpu_torch render --spectral \\
        --scene data/scenes/spectral.scene --width 1024 --height 1024 \\
        --spp 128 --chunk 8 --relax 2.0 --normal-taps 4 --out out.png
    python -m raymarchrenderer_tpu_torch train --scene sphere_on_floor \
        --width 1024 --height 1024 --spp 4 --max-bounces 4 --relax 1.9 \
        --normal-taps 4 --steps 3 --lr 1e-2 --target T.npy --out fit.npz
    python -m raymarchrenderer_tpu_torch train --spectral \
        --scene sphere_on_floor --width 1024 --height 1024 --spp 4 \
        --max-bounces 4 --relax 1.9 --normal-taps 4 --steps 3 --lr 1e-2 \
        --target T.npy --out fit.npz

The same flags as the JAX package's `render` and `train` subcommands that
these paths read, plus `--device` (default `cuda`; `--device cpu` runs the
plain PyTorch versions of the kernels).  On `cuda` with no card it fails.
`render --impl auto` picks as the JAX CLI does, with the card in the
TPU's place: the fused kernels on `cuda`, the oracle on the CPU.
`--env-map` (.hdr, .npy or .png) is the sky of a scene *file*, as in the
JAX package (a builtin scene name keeps its constant sky), for `render`
and `train`; under `--spectral` it is accepted and unused (the spectral
sky is a constant band in both packages).  A scene whose `environment`
holds an `sh` array renders with that SH sky.  Checkpoints (`--checkpoint`
/ `--resume`) and the other subcommands are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _build_scene(args):
    from raymarchrenderer_tpu_torch.scene import builtin, load_scene
    env = None
    if getattr(args, "env_map", None):
        from raymarchrenderer_tpu_torch.io import load_env_map
        env = load_env_map(args.env_map)
    if args.scene and os.path.exists(args.scene):
        return load_scene(args.scene, env_image=env)
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
    p.add_argument("--env-map", default=None,
                   help="equirect environment map (.hdr/.npy/.png) of a "
                        "scene file: the reference's veranda_1k.hdr slot "
                        "(Graphics.cpp:287)")
    p.add_argument("--direct-light", action="store_true",
                   help="next-event estimation / soft shadows")
    p.add_argument("--spectral", action="store_true",
                   help="gen-3 wavelength transport (RayMarch3.glsl); "
                        "without it the gen-1 RGB path tracer")
    p.add_argument("--relax", type=float, default=0.0,
                   help="over-relaxed sphere tracing omega (e.g. 2.0); "
                        "0 = reference-parity stepMultiply=0.5 march")
    p.add_argument("--normal-taps", type=int, choices=(0, 4, 6), default=6,
                   help="SDF normal estimator: 6 central-diff (parity), "
                        "4 tetrahedron (faster), 0 the exact gradient (one "
                        "reverse sweep of the scene map)")
    p.add_argument("--chunk", type=int, default=8,
                   help="samples per kernel launch")
    p.add_argument("--out", default=None,
                   help="output image (.png/.bmp/.exr/.npy); default "
                        "output/<timestamp>.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (the CUDA kernel) or cpu (its plain PyTorch "
                        "version)")


def pick_impl(impl: str, device) -> str:
    """`render --impl`: "auto" takes the fused kernels on a CUDA card and
    the oracle on the CPU (the JAX CLI's `_pick_impl`, with the card in
    the TPU's place); "fused" and "oracle" are taken as given."""
    if impl != "auto":
        return impl
    return "fused" if device.type == "cuda" else "oracle"


def cmd_render(args):
    """Render, print the rate, save the image; returns (image, n, render
    seconds), the seconds from the first launch to the image on the host.
    `--impl fused` renders in launches of `--chunk` samples through the
    kernels (their plain versions on the CPU); `--impl oracle` renders
    sample by sample with the wavefront integrators in plain PyTorch."""

    from raymarchrenderer_tpu_torch.io.image import save_image, timestamp_name
    from raymarchrenderer_tpu_torch.kernels.march import (
        MEGA_PATHS, MEGA_PATHS_DEFER, MEGA_SPECTRAL, prepare,
        render_progressive_fused, render_progressive_fused_spectral)
    from raymarchrenderer_tpu_torch.render.integrator import render
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table, render_spectral)

    device = _device(args.device)
    scene = _build_scene(args)
    params = scene.init_params(device)
    cfg = _config(args)
    corners = _camera(args).corner_rays_flat(device)
    impl = pick_impl(args.impl, device)
    if impl == "fused":
        # nvcc stays out of the render time
        build_s = prepare(device, MEGA_SPECTRAL if args.spectral else (
            MEGA_PATHS_DEFER if scene.has_env_map else MEGA_PATHS))
        if build_s is not None:
            print(f"kernel built and loaded in {build_s:.3f}s")
    kind = "spectral" if args.spectral else (
        "rgb, env map" if scene.has_env_map else "rgb")
    print(f"rendering {cfg.width}x{cfg.height} @ {cfg.spp} spp "
          f"({kind}, {device}) with the {impl} path")

    def progress(s, state):
        print(f"  {s}/{cfg.spp} spp", flush=True)

    def oracle_progress(s, state):
        if (s + 1) % args.chunk == 0 or s + 1 == cfg.spp:
            progress(s + 1, state)

    t0 = time.perf_counter()
    if args.spectral and impl == "fused":
        img, n = render_progressive_fused_spectral(
            scene, params, band_table(scene, device), cfg, corners,
            spp=cfg.spp, samples_per_launch=args.chunk, callback=progress)
    elif args.spectral:
        img, n = render_spectral(scene, params, band_table(scene, device),
                                 cfg, corners, spp=cfg.spp,
                                 callback=oracle_progress)
    elif impl == "fused":
        img, n = render_progressive_fused(
            scene, params, cfg, corners, spp=cfg.spp,
            samples_per_launch=args.chunk, direct_light=args.direct_light,
            callback=progress)
    else:
        img, n = render(scene, params, cfg, corners, spp=cfg.spp,
                        direct_light=args.direct_light,
                        callback=oracle_progress)
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


def load_target(path: str):
    """A train target as (H, W, 3) linear float32: .npy as it is, .exr
    linear, .png and .bmp decoded from sRGB."""
    import numpy as np

    from raymarchrenderer_tpu_torch.io.image import (_srgb_to_linear_np,
                                                     load_bmp, load_exr,
                                                     load_png)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".exr":
        return load_exr(path)
    if ext == ".png":
        return load_png(path).astype(np.float32)
    if ext == ".bmp":
        return _srgb_to_linear_np(
            load_bmp(path).astype(np.float32) / 255.0).astype(np.float32)
    raise SystemExit(f"unsupported target format: {path!r}")


def cmd_train(args):
    """Inverse rendering: fit every scene parameter to a target image by
    SGD through the differentiable render (`parallel.sharding`), write the
    fitted leaves (npz, `leaf{i}` in the JAX package's leaf order) and a
    PNG of the final render.  `--impl auto` records each step's marches
    with the recording megakernel; `fused` marches every bounce with
    `march_fused`; `oracle` uses the plain march (an explicit choice, not
    a fallback).  Returns (final loss, fitted params, the last step's
    gradients, the final render); with `--spectral` the band table is fit
    too and the fitted `SpectralMaterials` come third
    (`_train_spectral`)."""
    import numpy as np
    import torch

    from raymarchrenderer_tpu_torch.io.image import save_image
    from raymarchrenderer_tpu_torch.kernels.march import (
        MARCH_FUSED, MEGA_PATHS, MEGA_PATHS_DEFER, RECORD_PATHS, prepare)
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        render_sharded, sgd, train_grads_sharded)
    from raymarchrenderer_tpu_torch.scene.graph import params_to_numpy

    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    device = _device(args.device)
    scene = _build_scene(args)
    params = scene.init_params(device)
    cfg = _config(args)
    corners = _camera(args).corner_rays_flat(device)
    target = load_target(args.target)
    if target.shape != (cfg.height, cfg.width, 3):
        raise SystemExit(
            f"target is {target.shape}, render is "
            f"({cfg.height}, {cfg.width}, 3): pass matching --width/--height")
    target = torch.as_tensor(target, device=device)
    march_impl = {"auto": "recorded", "fused": "fused",
                  "oracle": "oracle"}[args.impl]
    if args.spectral:
        return _train_spectral(args, device, scene, params, cfg, corners,
                               target, march_impl)
    impl = "oracle" if args.impl == "oracle" else "fused"
    render_kernel = MEGA_PATHS_DEFER if scene.has_env_map else MEGA_PATHS
    kernels = {"recorded": (RECORD_PATHS,), "fused": (MARCH_FUSED,),
               "oracle": ()}[march_impl] + ((render_kernel,)
                                            if impl == "fused" else ())
    build_s = prepare(device, *kernels)
    if build_s is not None:
        print(f"kernels built and loaded in {build_s:.3f}s")
    print(f"training {cfg.width}x{cfg.height} @ {args.spp} spp, "
          f"{args.steps} steps ({march_impl}, {device})")
    for k in range(args.steps):
        t0 = time.perf_counter()
        loss, grads = train_grads_sharded(
            scene, params, cfg, corners, target, spp=args.spp,
            direct_light=args.direct_light, march_impl=march_impl)
        params = sgd(params, grads, args.lr)
        loss_f = float(loss)            # waits for the device
        if k % max(1, args.steps // 10) == 0 or k == args.steps - 1:
            print(f"step {k:4d} loss {loss_f:.6f} "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
    img = render_sharded(scene, params, cfg, corners, spp=args.spp,
                         direct_light=args.direct_light, impl=impl)
    out = args.out or "output/fitted_params.npz"
    if not out.endswith(".npz"):
        out += ".npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, **{f"leaf{i}": a
                     for i, a in enumerate(params_to_numpy(params))})
    png = os.path.splitext(out)[0] + ".png"
    save_image(png, img.cpu().numpy())
    print(f"saved {out} and {png} (final loss {loss_f:.6f})")
    return loss, params, grads, img


def _train_spectral(args, device, scene, params, cfg, corners, target,
                    march_impl):
    """`train --spectral`: fit the scene parameters (SGD) and the band
    table's rows (a sign step, `parallel.sharding.spectral_update`) to the
    target through the soft-band differentiable spectral render, a fresh
    sample batch per step (sample0 = k * spp); the final render is one
    launch of the spectral megakernel.  The npz holds the fitted band rows
    (`band_min_wave`, `band_max_wave`, `band_power`) and the scene leaves
    (`leaf{i}`, the JAX package's leaf order).  Returns (final loss,
    fitted params, fitted `SpectralMaterials`, the last step's (param
    grads, band grads), the final render)."""
    import numpy as np

    from raymarchrenderer_tpu_torch.io.image import save_image
    from raymarchrenderer_tpu_torch.kernels.march import (
        MARCH_FUSED, MEGA_SPECTRAL, RECORD_SPECTRAL, prepare)
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        render_sharded_spectral, spectral_update,
        train_grads_spectral_sharded)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)
    from raymarchrenderer_tpu_torch.scene.graph import params_to_numpy

    mats = band_table(scene, device)
    kernels = {"recorded": (RECORD_SPECTRAL,), "fused": (MARCH_FUSED,),
               "oracle": ()}[march_impl] + (MEGA_SPECTRAL,)
    build_s = prepare(device, *kernels)
    if build_s is not None:
        print(f"kernels built and loaded in {build_s:.3f}s")
    print(f"training spectral {cfg.width}x{cfg.height} @ {args.spp} spp, "
          f"{args.steps} steps ({march_impl}, {device})")
    for k in range(args.steps):
        t0 = time.perf_counter()
        loss, grads, band_grads = train_grads_spectral_sharded(
            scene, params, mats, cfg, corners, target, spp=args.spp,
            march_impl=march_impl, sample0=k * args.spp)
        params, mats = spectral_update(params, mats, grads, band_grads,
                                       args.lr)
        loss_f = float(loss)            # waits for the device
        if k % max(1, args.steps // 10) == 0 or k == args.steps - 1:
            print(f"step {k:4d} loss {loss_f:.6f} "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
    img = render_sharded_spectral(scene, params, mats, cfg, corners,
                                  spp=args.spp)
    out = args.out or "output/fitted_params.npz"
    if not out.endswith(".npz"):
        out += ".npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, band_min_wave=mats.min_wave.cpu().numpy(),
             band_max_wave=mats.max_wave.cpu().numpy(),
             band_power=mats.power.cpu().numpy(),
             **{f"leaf{i}": a for i, a in enumerate(params_to_numpy(params))})
    png = os.path.splitext(out)[0] + ".png"
    save_image(png, img.cpu().numpy())
    print(f"saved {out} and {png} (final loss {loss_f:.6f})")
    return loss, params, mats, (grads, band_grads), img


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raymarchrenderer_tpu_torch",
        description="sphere-tracing path tracer, PyTorch + CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to an image")
    _add_render_flags(pr)
    pr.add_argument("--impl", choices=("auto", "fused", "oracle"),
                    default="auto",
                    help="fused: the CUDA kernels (their plain versions "
                         "on the CPU); oracle: the plain wavefront "
                         "integrators; auto: fused on a card, oracle on "
                         "the CPU")
    pr.set_defaults(fn=cmd_render)
    pt = sub.add_parser("train", help="inverse-render: fit the scene's "
                                      "parameters to a target image")
    _add_render_flags(pt)
    pt.add_argument("--target", required=True,
                    help="target image (.png/.bmp sRGB, .exr linear, .npy "
                         "linear float32), the size of --width/--height")
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--lr", type=float, default=1e-2)
    pt.add_argument("--impl", choices=("auto", "fused", "oracle"),
                    default="auto",
                    help="auto: the recording megakernel; fused: "
                         "march_fused per bounce; oracle: the plain march")
    pt.set_defaults(fn=cmd_train)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
