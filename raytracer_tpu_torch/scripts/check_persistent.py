"""On-card estimator self-check: the production render path is the same
Monte-Carlo estimator as an independently written one (port of the JAX
package's scripts/check_persistent_tpu.py, check for check).

    python -m raytracer_tpu_torch.scripts.check_persistent [spp] [--device cuda]

The port's kernels are held bit for bit against their own plain twins
(chip_smoke.py), which shows the CUDA code does what its twin does. This
check shows, on the card and at the reference scenes' sizes, that the
kernel path and a separately written path give the same image in
expectation:

* "fast": `render_image` on the scene's `render_path` (kernel 2, the
  regenerative wavefront with russian roulette, rr_max_q 0.75 from depth 5);
* "independent": `render_image(regenerative=False)`: passes of
  `pass_block` -> `trace` (kernel 1 for each bounce's closest hit,
  PyTorch shading, no russian roulette, the deterministic 4-tap image
  filter).

Both are unbiased and differ on purpose (roulette, filter, schedule), so
only their statistics are compared, never pixels, by the JAX check's rule
(`agree`): each channel's image mean within rtol 0.02 and atol 0.004, and
the image standard deviations within 5% of max(std, 0.1).

The scenes: rand_spheres, perlin, quads, simple_light, cornell, earth, and
earth with bilinear filtering by kernel 2's deterministic 4-tap and by its
stochastic single tap, at width 200 and `spp` (64). Two more checks:
`check_sample_counter` (exact per-pixel sample accounting when the
wavefront is smaller than the pixel count) and
`check_large_scene_clustered` (10K spheres: kernel 2's culled walk on the
host-clustered scene against dense kernel 1). On the card each render
must also have launched its path's kernel. The JAX check's
`earth_megakernel` row checks a TPU fallback that the port has no
counterpart of.

Prints one JSON line {"ok", "spp", "device", "scenes"}; exits 0 only if
every check passes. `--device cpu` runs the plain twins (slow at these
sizes).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from raytracer_tpu_torch.core.camera import make_camera
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.render.driver import render_image, render_path, resolve_device
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils import launches
from raytracer_tpu_torch.utils.metrics import card_identity

# (label, registered scene, builder kwargs, render_image kwargs of the
# fast render)
SCENES = (
    ("rand_spheres", "rand_spheres", {}, {}),
    ("perlin", "perlin", {}, {}),
    ("quads", "quads", {}, {}),
    ("simple_light", "simple_light", {}, {}),
    ("cornell", "cornell", {}, {}),
    ("earth", "earth", {}, {}),
    ("earth_bilinear", "earth", dict(bilinear=True), dict(bilinear_stochastic=False)),
    ("earth_bilinear_stochastic", "earth", dict(bilinear=True), dict(bilinear_stochastic=True)),
)
# Both paths draw from the counter RNG keyed by (seed, sample id)
# (ops/ctr_rng.py), so under one seed their camera rays and first bounces
# would share uniforms, correlate the two estimates and could hide a bias
# that moves both alike. Each path gets its own seed. (The JAX check gave
# both the same key, but its fast path drew from the TPU's hardware PRNG.)
FAST_SEED = 11
INDEPENDENT_SEED = 12
# The fast path's kernel and the independent path's, on the card.
FAST_KERNEL = "persistent_render"
INDEPENDENT_KERNEL = "closest_hit"


def agree(a, b) -> dict:
    """The JAX check's verdict on images `a` (fast) and `b` (independent),
    (H, W, 3) arrays: every channel's image mean within rtol 0.02 and atol
    0.004 of b's, and |std(a) - std(b)| < 0.05 * max(std(b), 0.1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mean_a, mean_b = a.mean((0, 1)), b.mean((0, 1))
    std_a, std_b = float(a.std()), float(b.std())
    ok = bool(np.allclose(mean_a, mean_b, rtol=0.02, atol=0.004)
              and abs(std_a - std_b) < 0.05 * max(std_b, 0.1))
    return {"ok": ok, "mean_fast": mean_a.round(4).tolist(),
            "mean_independent": mean_b.round(4).tolist(), "std": [round(std_a, 4), round(std_b, 4)]}


def _counted(fn):
    """(fn(), the kernels' launches during it)."""
    launches.reset()
    out = fn()
    return out, launches.read()


def compare(scene, cam, settings, device, fast_kw=None) -> dict:
    """`agree` on the fast and the independent render of one scene, with
    each render's launches; on the card, ok also needs the fast render to
    have launched kernel 2 and the independent one kernel 1 and not kernel
    2."""
    dev = resolve_device(device)
    fast, fast_counts = _counted(lambda: render_image(
        scene, cam, settings, device=dev, seed=FAST_SEED, **(fast_kw or {})).cpu().numpy())
    ind, ind_counts = _counted(lambda: render_image(
        scene, cam, settings, device=dev, seed=INDEPENDENT_SEED,
        regenerative=False).cpu().numpy())
    out = agree(fast, ind)
    out.update(path=render_path(scene), kernels_fast=fast_counts, kernels_independent=ind_counts,
               finite=bool(np.isfinite(fast).all() and np.isfinite(ind).all()))
    if dev.type == "cuda":
        out["ok"] = out["ok"] and (fast_counts[FAST_KERNEL] > 0
                                   and ind_counts[INDEPENDENT_KERNEL] > 0
                                   and ind_counts[FAST_KERNEL] == 0)
    out["ok"] = out["ok"] and out["finite"]
    return out


def check_scene(label: str, device, spp: int = 64, width: int = 200) -> dict:
    """`compare` on SCENES' entry `label` at `width` and `spp`."""
    _, name, build_kw, fast_kw = next(s for s in SCENES if s[0] == label)
    scene, cam, settings = get_scene(name, width=width, spp=spp, **build_kw)
    return compare(scene, cam, settings, device, fast_kw)


def check_sample_counter(device, width: int = 600, spp: int = 16,
                         wavefront: int = 294912) -> dict:
    """Exact per-pixel sample accounting with fewer wavefront lanes than
    pixels (294,912 < 360,000 by default): the scene without geometry
    under a white background, so every sample's radiance is 1 and every
    pixel of the mean must be exactly 1.0. (The JAX check's regime, where
    XLA:TPU once put spp + 1 samples on some pixels.)"""
    dev = resolve_device(device)
    scene = SceneBuilder(0).build()
    cam, settings = make_camera(1.0, width, samples_per_pixel=spp, max_depth=8,
                                background=(1.0, 1.0, 1.0))
    a = render_image(scene, cam, settings, device=dev, seed=0,
                     wavefront=wavefront)[..., 0].cpu().numpy()
    bad = int((a != 1.0).sum())
    return {"ok": bad == 0, "bad_pixels": bad, "minmax": [float(a.min()), float(a.max())],
            "pixels": width * settings.height, "wavefront": wavefront}


def check_large_scene_clustered(device, spp: int = 32, width: int = 200,
                                n_spheres: int = 10000) -> dict:
    """rand_spheres_large's 10K-sphere grid: the fast path clusters it on
    the host and kernel 2 culls clusters; the independent path's kernel 1
    searches every sphere. Statistically, by `agree`."""
    scene, cam, settings = get_scene("rand_spheres_large", width=width, spp=spp,
                                     n_spheres=n_spheres)
    return compare(scene, cam, settings, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spp", type=int, nargs="?", default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_identity(dev)
    results = {
        "sample_counter_small_wavefront": check_sample_counter(dev),
        "large_10k_clustered_vs_dense": check_large_scene_clustered(dev),
    }
    for label, *_ in SCENES:
        results[label] = check_scene(label, dev, spp=args.spp)
    ok = all(r["ok"] for r in results.values())
    print(json.dumps({"ok": ok, "spp": args.spp,
                      "device": {"name": card["name"], "power_limit_w": card["power_limit_w"]},
                      "scenes": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
