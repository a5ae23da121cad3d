"""Golden-image parity against the reference's own 2015 renders: the
port's copy of the JAX package's `utils/parity.py`.

The gates (`luma`, `ssim`, `_label_components`, `channel_centroid`,
`channel_bbox`, `gate_one`, `GATED_GOLDENS`, the golden pose) are numpy
and the JAX package's, line for line; `tools/reference_parity.py`
documents the method (camera recovery, detectors, each era's content
deltas).  The five gated goldens ship as x4-downscaled (320 x 180) arrays
with the re-authored `default_parity.scene`, byte-identical copies of the
JAX package's, under `raymarchrenderer_tpu_torch/data/parity/`.  When the
reference mount is present (`have_reference_mount`: a checkout of the
reference, "RayMarch Renderer", named by the RAYMARCH_REFERENCE
environment variable, with the JAX package's layout below it: its 2015
renders under `output/`, its scene at `data/scenes/default.scene`), the
full-resolution BMPs and the reference's own scene file are used
instead, and `run_parity` compares at full resolution by default, as the
JAX package does from a source checkout.  `run_parity` renders with the
port: the RGB kernel
(`kernels.march.render_fused`) in launches of 64 samples on a CUDA card,
the oracle `render` on the CPU.

Classification of all 24 committed reference renders (thumbnails and
notes in docs/reference_parity.md).  All but one depict default.scene
across development eras:

  07-11_01-41 .. 07-11_14-47  early era: spheres FLOAT above the floor
                              with hard shadow blobs; heavy MC noise
  07-11_16-00                 magenta debug frame (solid #FF00FF)
  07-11_16-48, 07-16_13-25,   near-black debug/broken renders
  07-16_13-55
  07-12_15-14, 07-12_16-04    glossy/glass-sphere era, converged
  07-12_23-07                 matte era, converged — the round-2 gate
  07-19_17-03                 dark glossy era (reflective spheres)
  07-19_17-20                 bright diffuse era, converged
  07-19_19-48, 07-19_20-05    bright era with patterned sky / corner
                              light
  07-20_20-46                 DIFFERENT scene: one black glossy sphere
                              (8-bit palette BMP)
  07-29_10-42                 refractive-blue-sphere era, firefly noise
"""
from __future__ import annotations

import json
import os

import numpy as np

# the reference mount: the JAX package's REF_DIR and REF_SCENE below the
# reference checkout that RAYMARCH_REFERENCE names (None when it is unset:
# the port reads nothing outside its package unless told where)
_REF_ROOT = os.environ.get("RAYMARCH_REFERENCE") or None
REF_DIR = None if _REF_ROOT is None else os.path.join(_REF_ROOT, "output")
REF_SCENE = None if _REF_ROOT is None else os.path.join(
    _REF_ROOT, "data", "scenes", "default.scene")
_PKG_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
_PKG_SCALE = 4  # the packaged goldens are x4-downscaled

# the pose fixed by the 2015 goldens (see tools/reference_parity.py)
GOLDEN_EYE = (0.0, 4.0, -6.0)
GOLDEN_DIR = (0.0, -4.0, 6.0)

# The GATED set: every converged default.scene golden with a distinct
# era, each carrying its documented content delta vs reference HEAD's
# scene constants.  The camera GEOMETRY gates (red-sphere centroid,
# green-panel centroid/bbox) apply to all of them — the 2015 pose is the
# same — while luma statistics shift with each era's lighting, so the
# per-golden luma floor is set from measured values with margin.
# Floors are measured-at-convergence (1280x720 @ 2048 spp on-chip,
# output/reference_parity_tpu.json) minus a regression margin — the gate
# must be able to FAIL without flagging the documented era deltas:
#   23-07: r = -0.436 measured (our render is brighter overall and the
#          2015 floor shading inverts the contrast — mean luma 0.54 vs
#          0.24; the round-2..4 artifacts documented exactly this)
#   17-20: r = +0.794 measured — the bright diffuse era matches our
#          lighting best, making this the strongest luma regression gate
#          in the set; its brighter panel FACE also shifts the green
#          body centroid up (~186 px), hence the larger budget (the
#          padded-bbox containment stays the positional check)
#   16-04: r = +0.098 measured (glossy-era highlights decorrelate luma)
GATED_GOLDENS = {
    "2015-07-12_23-07": {
        # the original round-2 gate: matte converged era
        "delta": "volumeScatter sphere renders blue in 2015; darker floor",
        "luma_r_min": -0.55,
        "green_budget_px": 150.0,
    },
    "2015-07-19_17-20": {
        "delta": "bright diffuse era: floor ~2x brighter than HEAD "
                 "constants; spheres matte",
        "luma_r_min": 0.65,
        "green_budget_px": 250.0,
    },
    "2015-07-12_16-04": {
        "delta": "glossy/glass sphere era: specular highlights and soft "
                 "sphere interreflections absent from HEAD's matte "
                 "materials",
        "luma_r_min": -0.10,
        "green_budget_px": 150.0,
    },
    # round-5b breadth: two more eras whose geometry anchors measured
    # cleanly against the converged full-res render (red_d 12.3 / 8.9 px,
    # green in-bbox for both)
    "2015-07-29_10-42": {
        "delta": "refractive-blue-sphere era (latest golden): heavy "
                 "firefly noise, bright backdrop decorrelates luma "
                 "(r = +0.06 measured).  Like 17-20 the green-body "
                 "centroid is detector-sensitive (fireflies shift the "
                 "largest component under downscale: 107.6 full-res px "
                 "but 47.3·4 at ×4), so the centroid budget is the loose "
                 "one and the bbox containment stays the positional gate",
        "luma_r_min": -0.10,
        "green_budget_px": 250.0,
    },
    "2015-07-11_01-41": {
        "delta": "earliest era: spheres FLOAT above the floor with hard "
                 "shadow blobs and heavy MC noise; dark backdrop inverts "
                 "contrast like 23-07 (r = -0.43 measured)",
        "luma_r_min": -0.55,
        "green_budget_px": 150.0,
    },
}


def luma(u8):
    f = u8.astype(np.float32) / 255.0
    return 0.2126 * f[..., 0] + 0.7152 * f[..., 1] + 0.0722 * f[..., 2]


def ssim(a, b):
    """Global SSIM on float [0,1] images (single window — converged-vs-
    converged comparison wants a scalar; MC residue defeats 8x8
    windows)."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ma, mb = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - ma) * (b - mb)).mean()
    return float(((2 * ma * mb + c1) * (2 * cov + c2))
                 / ((ma ** 2 + mb ** 2 + c1) * (va + vb + c2)))


def _label_components(mask):
    """8-connected labels (scipy.ndimage.label)."""
    from scipy import ndimage
    return ndimage.label(mask, structure=np.ones((3, 3), int))


def _largest_component_mask(u8, chan):
    """Ratio-dominance mask at a low brightness floor, largest
    8-connected component (the round-3 detector — see the tool)."""
    f = u8.astype(np.float32)
    o1, o2 = [c for c in range(3) if c != chan]
    mask = (f[..., chan] > 20) & (f[..., chan] > 1.3 * f[..., o1]) \
        & (f[..., chan] > 1.3 * f[..., o2])
    if not mask.any():
        return None
    lab, n = _label_components(mask)
    sizes = np.bincount(lab.ravel(), minlength=n + 1)[1:]
    return lab == (1 + int(np.argmax(sizes)))


def channel_centroid(u8, chan):
    big = _largest_component_mask(u8, chan)
    if big is None:
        return None
    ys, xs = np.nonzero(big)
    return float(xs.mean()), float(ys.mean())


def channel_bbox(u8, chan):
    big = _largest_component_mask(u8, chan)
    if big is None:
        return None
    ys, xs = np.nonzero(big)
    return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())


def dist(a, b):
    if a is None or b is None:
        return None
    return float(np.hypot(a[0] - b[0], a[1] - b[1]))


def have_reference_mount() -> bool:
    return (REF_DIR is not None and REF_SCENE is not None
            and os.path.isdir(REF_DIR) and os.path.exists(REF_SCENE))


def load_golden(ref_name: str, f: int):
    """Golden pixels at downscale f: the full-resolution BMP when the
    reference mount holds it, else the packaged x4 array (f below 4 is
    taken as 4; f must be a multiple of 4)."""
    bmp = None if REF_DIR is None else os.path.join(REF_DIR,
                                                     ref_name + ".bmp")
    if bmp is not None and os.path.exists(bmp):
        from raymarchrenderer_tpu_torch.io.image import load_bmp
        ref = load_bmp(bmp)
        base = 1
    else:
        npz = os.path.join(_PKG_DATA, "parity", ref_name + ".npz")
        with np.load(npz) as z:
            ref = z["image"]
        base = _PKG_SCALE
        if f < base:
            f = base
        if f % base:
            raise ValueError(f"packaged goldens are x{base}; PARITY_SCALE "
                             f"must be a multiple of {base}")
    k = f // base
    if k > 1:
        H, W = ref.shape[:2]
        h, w = H // k, W // k
        ref = ref[:h * k, :w * k].reshape(h, k, w, k, 3) \
            .mean(axis=(1, 3)).astype(np.uint8)
    return ref


def scene_path() -> str:
    if REF_SCENE is not None and os.path.exists(REF_SCENE):
        return REF_SCENE
    # without the mount: the packaged geometric parity TWIN of the
    # reference's default.scene (object layout cited from its map nodes:
    # floor box (0,-1.025,0)x(32,0.05,32), red sphere (-1,0,0) r1,
    # volumeScatter sphere (1,0.1,0) r1, green glass panel box (-4,1,0)
    # x(0.05,2,2), emitter sphere (8,8,-4) r3 power 16)
    return os.path.join(_PKG_DATA, "parity", "default_parity.scene")


def gate_one(ref_name: str, ref, ours, spec: dict, f: int = 1) -> dict:
    """Gate ONE golden against the (shared) render: geometry gates
    (centroids/bbox — the 2015 pose is common to every era) plus the
    per-era luma-correlation floor.

    `f` is the downscale factor the images were rendered/compared at;
    every pixel budget in the spec (and in the gate NAMES) is expressed
    in FULL-RESOLUTION pixels and divided by `f` before comparison, so
    the packaged x4 gates are exactly as tight as the source-checkout
    full-res gates (review finding: unscaled budgets made the wheel
    gates ~4x weaker — a 60-full-res-px camera drift is 15 px at x4 and
    passed)."""
    la, lb = luma(ref), luma(ours)
    r = float(np.corrcoef(la.ravel(), lb.ravel())[0, 1])
    s = ssim(la, lb)
    red_ref = channel_centroid(ref, 0)
    red_our = channel_centroid(ours, 0)
    green_ref = channel_centroid(ref, 1)
    green_our = channel_centroid(ours, 1)
    rd = dist(red_ref, red_our)
    gd = dist(green_ref, green_our)
    gbox = channel_bbox(ref, 1)
    in_box = None
    if gbox is not None and green_our is not None:
        # relative pad scales with the (already-downscaled) bbox; the
        # absolute anti-noise term is 8 FULL-RES px
        pad_x = 0.15 * (gbox[2] - gbox[0]) + 8.0 / f
        pad_y = 0.15 * (gbox[3] - gbox[1]) + 8.0 / f
        in_box = (gbox[0] - pad_x <= green_our[0] <= gbox[2] + pad_x
                  and gbox[1] - pad_y <= green_our[1] <= gbox[3] + pad_y)
    budget = spec.get("green_budget_px", 150.0)
    gates = {
        # names quote full-res budgets; comparisons are /f
        "red_centroid_lt_20px": rd is not None and rd < 20.0 / f,
        "green_centroid_in_ref_panel_bbox": bool(in_box),
        f"green_centroid_lt_{budget:.0f}px": gd is not None
        and gd < budget / f,
        "luma_pearson_r_floor": r >= spec.get("luma_r_min", -1.0),
    }
    return {
        "ref": ref_name,
        "scale": f,
        "content_delta": spec.get("delta"),
        "luma_pearson_r": round(r, 4),
        "ssim_luma": round(s, 4),
        "red_sphere_centroid_ref": red_ref,
        "red_sphere_centroid_ours": red_our,
        "red_centroid_dist_px": None if rd is None else round(rd, 2),
        "green_panel_centroid_ref": green_ref,
        "green_panel_centroid_ours": green_our,
        "green_centroid_dist_px": None if gd is None else round(gd, 2),
        "mean_luma_ref": round(float(la.mean()), 4),
        "mean_luma_ours": round(float(lb.mean()), 4),
        "gates": gates,
        "pass": all(gates.values()),
    }


def parity_scale() -> int:
    """The downscale of a parity run: PARITY_SCALE, by default 1 with the
    reference mount and x4 without it."""
    mount = have_reference_mount()
    f = int(os.environ.get("PARITY_SCALE", "1" if mount else str(_PKG_SCALE)))
    if not mount and f < _PKG_SCALE:
        # the packaged goldens exist at x4 only: load_golden would clamp
        # the PIXELS to x4 while gate_one(f=1) kept the full-res budgets,
        # 4x weaker gates.  Clamp both.
        f = _PKG_SCALE
    return f


def run_parity(camera=None, out_dir: str = "output",
               device="cuda") -> int:
    """Render the default scene once at the 2015 golden pose and gate
    every entry of GATED_GOLDENS (or the single PARITY_REF), on `device`
    (the card by default).  PARITY_SPP sets the samples (2048 on a card,
    64 on the CPU), PARITY_SCALE the downscale (`parity_scale`).  Prints
    one JSON report line; returns a process exit code (0: every gate
    passes)."""
    import torch

    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.io.image import (_srgb_to_linear_np,
                                                     save_png, to_srgb_u8)
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.scene.graph import load_scene

    device = torch.device(device)
    cuda = device.type == "cuda"
    spp = int(os.environ.get("PARITY_SPP", "2048" if cuda else "64"))
    f = parity_scale()
    env_ref = os.environ.get("PARITY_REF")
    if env_ref:
        names = [env_ref]
        specs = {env_ref: GATED_GOLDENS.get(
            env_ref, {"delta": "ungated era (diagnostic run)",
                      "luma_r_min": 0.0})}
    else:
        names = list(GATED_GOLDENS)
        specs = GATED_GOLDENS
    refs = {n: load_golden(n, f) for n in names}
    h, w = refs[names[0]].shape[:2]

    scene = load_scene(scene_path())
    params = scene.init_params(device)
    cfg = RenderConfig(width=w, height=h, max_bounces=16, max_steps=512,
                       relax_omega=1.9, normal_taps=4)
    cam = camera or Camera(eye=GOLDEN_EYE, direction=GOLDEN_DIR,
                           aspect=w / h)
    corners = cam.corner_rays_flat(device)

    if cuda:
        from raymarchrenderer_tpu_torch.kernels.march import render_fused
        chunk, n = 64, 0
        img = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
        while n < spp:
            k = min(chunk, spp - n)
            c = render_fused(scene, params, cfg, corners, n, n_samples=k)
            img = (img * n + c * k) / (n + k)
            n += k
    else:
        from raymarchrenderer_tpu_torch.render.integrator import render
        img, n = render(scene, params, cfg, corners, spp=spp)
    ours = to_srgb_u8(img.cpu().numpy())

    reports = [gate_one(nm, refs[nm], ours, specs[nm], f=f)
               for nm in names]

    side = np.concatenate([refs[names[0]], ours], axis=1)
    os.makedirs(out_dir, exist_ok=True)
    save_png(os.path.join(out_dir, "reference_parity.png"),
             _srgb_to_linear_np(side.astype(np.float32) / 255.0))

    ok = all(rep["pass"] for rep in reports)
    print(json.dumps({
        "size": [w, h], "spp": int(n), "platform": device.type,
        "reference_mount": have_reference_mount(),
        "goldens": reports,
        "pass": ok,
    }))
    return 0 if ok else 1
