"""The benchmark's scene descriptions: plain numbers, made from a
configuration file, that both the program and the reference read.

A configuration's "scene" holds `spheres` and `quads`, each an entry with
its `material`, plus generators that expand in place:

* `{"grid": {...}}` among the spheres: the random sphere field of *Ray
  Tracing in One Weekend*'s final scene, drawn from the grid's own `seed`
  (numpy's default_rng, in the book's order of draws);
* `{"box": {"a": [...], "b": [...], "material": ...}}` among the quads: an
  axis-aligned box as its six faces.

A material is one of `{"lambertian": texture}`, `{"metal": {"albedo",
"fuzz"}}`, `{"dielectric": {"ior"}}` and `{"light": texture}`, a texture
an RGB triple or `{"checker": {"scale", "even", "odd"}}`.

`describe` flattens that into `Description`: texture, material, sphere and
quad rows, numbered as the program's SceneBuilder numbers them when they
are added in order. Every coordinate is rounded to float32 once, here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SOLID, CHECKER = "solid", "checker"
LAMBERTIAN, METAL, DIELECTRIC, LIGHT = "lambertian", "metal", "dielectric", "light"


def f32(values) -> list[float]:
    """Each value rounded to float32, as a list of Python floats."""
    return [float(v) for v in np.asarray(values, np.float32).reshape(-1)]


@dataclass
class Description:
    """A scene as rows of plain numbers. Textures: (kind, c0, c1, scale);
    materials: (kind, albedo, fuzz, ior, texture id); spheres: (center,
    radius, material id); quads: (q, u, v, material id)."""

    textures: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    spheres: list = field(default_factory=list)
    quads: list = field(default_factory=list)

    def texture(self, spec) -> int:
        if isinstance(spec, dict):
            c = spec["checker"]
            self.textures.append((CHECKER, f32(c["even"]), f32(c["odd"]), f32([c["scale"]])[0]))
        else:
            self.textures.append((SOLID, f32(spec), [0.0, 0.0, 0.0], 0.0))
        return len(self.textures) - 1

    def material(self, spec: dict) -> int:
        (kind, arg), = spec.items()
        if kind in (LAMBERTIAN, LIGHT):
            row = (kind, [0.0, 0.0, 0.0], 0.0, 1.0, self.texture(arg))
        elif kind == METAL:
            row = (kind, f32(arg["albedo"]), f32([arg["fuzz"]])[0], 1.0, 0)
        elif kind == DIELECTRIC:
            row = (kind, [0.0, 0.0, 0.0], 0.0, f32([arg["ior"]])[0], 0)
        else:
            raise ValueError(f"unknown material {kind!r}")
        self.materials.append(row)
        return len(self.materials) - 1

    def sphere(self, center, radius, material: dict) -> None:
        mat = self.material(material)
        self.spheres.append((f32(center), f32([radius])[0], mat))

    def quad(self, q, u, v, material) -> None:
        mat = material if isinstance(material, int) else self.material(material)
        self.quads.append((f32(q), f32(u), f32(v), mat))


def sphere_grid(desc: Description, g: dict) -> None:
    """The book's random field (main.go:246-276): for each cell (i, j) of
    `range` x `range`, a material draw, a centre jittered by `jitter` at
    height `y`, skipped within `avoid_dist` of `avoid`; then lambertian
    (albedo a product of two uniform triples), metal (albedo in
    `metal_albedo`, fuzz in `fuzz`) or glass, by `p_lambertian` and
    `p_metal`."""
    rng = np.random.default_rng(g["seed"])
    avoid = np.asarray(g["avoid"], np.float64)
    lo, hi = g["range"]
    for i in range(lo, hi):
        for j in range(lo, hi):
            choice = rng.random()
            center = np.array([i + g["jitter"] * rng.random(), g["y"],
                               j + g["jitter"] * rng.random()], np.float32)
            if np.linalg.norm(center - avoid) <= g["avoid_dist"]:
                continue
            if choice < g["p_lambertian"]:
                mat = {LAMBERTIAN: list(rng.random(3) * rng.random(3))}
            elif choice < g["p_lambertian"] + g["p_metal"]:
                albedo = rng.uniform(*g["metal_albedo"], 3)
                mat = {METAL: {"albedo": list(albedo), "fuzz": rng.uniform(*g["fuzz"])}}
            else:
                mat = {DIELECTRIC: {"ior": g["ior"]}}
            desc.sphere(center, g["radius"], mat)


def box_quads(desc: Description, a, b, material: dict) -> None:
    """An axis-aligned box between corners `a` and `b` as six quads (front,
    right, back, left, top, bottom), one material for all."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mn, mx = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0, 0], np.float32)
    dy = np.array([0, mx[1] - mn[1], 0], np.float32)
    dz = np.array([0, 0, mx[2] - mn[2]], np.float32)
    mat = desc.material(material)
    for q, u, v in (((mn[0], mn[1], mx[2]), dx, dy), ((mx[0], mn[1], mx[2]), -dz, dy),
                    ((mx[0], mn[1], mn[2]), -dx, dy), ((mn[0], mn[1], mn[2]), dz, dy),
                    ((mn[0], mx[1], mx[2]), dx, -dz), ((mn[0], mn[1], mn[2]), dx, dz)):
        desc.quad(q, u, v, mat)


def describe(scene: dict) -> Description:
    """The flat description of a configuration's "scene"."""
    desc = Description()
    for s in scene.get("spheres", []):
        if "grid" in s:
            sphere_grid(desc, s["grid"])
        else:
            desc.sphere(s["center"], s["radius"], s["material"])
    for q in scene.get("quads", []):
        if "box" in q:
            box_quads(desc, q["box"]["a"], q["box"]["b"], q["box"]["material"])
        else:
            desc.quad(q["q"], q["u"], q["v"], q["material"])
    return desc


def image_size(camera: dict) -> tuple[int, int]:
    """(width, height) of a camera entry: the height is floor(width) /
    aspect truncated, at least 1 (the book's rule)."""
    w = int(camera["width"])
    return w, max(1, int(float(w) / float(camera["aspect"])))
