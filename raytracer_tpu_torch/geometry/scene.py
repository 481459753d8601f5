"""Scene representation: structure-of-arrays tables as torch tensors.

Port of raytracer_tpu/geometry/scene.py. Geometry is `(S, 3)`/`(Q, 3)`
tables, materials a type enum plus a parameter table, textures likewise; all
dispatch happens per lane in the shading code. `SceneBuilder` is the
host-side construction API and produces exactly the tables the JAX builder
produces (same numpy construction, same dtypes, same padding rules).

Dummy rows keep the JAX encodings: a padded sphere has radius 0, a padded
quad has u = v = 0 (zero normal), and both never hit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from raytracer_tpu_torch.utils import trace as tr

# Material type enum (reference: concrete Material impls, materials.go).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3

# Texture type enum (reference: concrete Texture impls, materials.go).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

PERLIN_POINT_COUNT = 256

# Tensor fields in declaration order, with their dtypes.
TENSOR_FIELDS = {
    "sph_center": torch.float32,  # (S, 3)
    "sph_radius": torch.float32,  # (S,)  (negative = hollow-glass trick)
    "sph_mat": torch.int32,  # (S,)
    "quad_q": torch.float32,  # (Q, 3)
    "quad_u": torch.float32,  # (Q, 3)
    "quad_v": torch.float32,  # (Q, 3)
    "quad_mat": torch.int32,  # (Q,)
    "mat_type": torch.int32,  # (M,)
    "mat_albedo": torch.float32,  # (M, 3) — Metal's flat albedo
    "mat_fuzz": torch.float32,  # (M,)
    "mat_ior": torch.float32,  # (M,)
    "mat_tex": torch.int32,  # (M,) texture id for Lambertian/DiffuseLight
    "tex_type": torch.int32,  # (T,)
    "tex_c0": torch.float32,  # (T, 3) solid color / checker even
    "tex_c1": torch.float32,  # (T, 3) checker odd
    "tex_scale": torch.float32,  # (T,) checker / noise scale
    "tex_image": torch.int32,  # (T,) index into `images`
    "images": torch.float32,  # (I, H, W, 3) in [0, 1], padded to a common (H, W)
    "image_dims": torch.int32,  # (I, 2) true (H, W)
    "perlin_vec": torch.float32,  # (256, 3)
    "perlin_px": torch.int32,  # (256,)
    "perlin_py": torch.int32,
    "perlin_pz": torch.int32,
}
FLAG_FIELDS = (
    "has_image",
    "has_noise",
    "has_checker",
    "perlin_procedural",
    "bilinear_textures",
)


@dataclass
class Scene:
    """Scene tables (tensors) plus static flags gating optional texture work."""

    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    quad_q: torch.Tensor
    quad_u: torch.Tensor
    quad_v: torch.Tensor
    quad_mat: torch.Tensor
    mat_type: torch.Tensor
    mat_albedo: torch.Tensor
    mat_fuzz: torch.Tensor
    mat_ior: torch.Tensor
    mat_tex: torch.Tensor
    tex_type: torch.Tensor
    tex_c0: torch.Tensor
    tex_c1: torch.Tensor
    tex_scale: torch.Tensor
    tex_image: torch.Tensor
    images: torch.Tensor
    image_dims: torch.Tensor
    perlin_vec: torch.Tensor
    perlin_px: torch.Tensor
    perlin_py: torch.Tensor
    perlin_pz: torch.Tensor
    has_image: bool = False
    has_noise: bool = False
    has_checker: bool = False
    perlin_procedural: bool = False
    bilinear_textures: bool = False

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_quads(self) -> int:
        return self.quad_q.shape[0]

    @property
    def num_prims(self) -> int:
        return self.num_spheres + self.num_quads

    def to(self, device) -> "Scene":
        """Copy of the scene with every table on `device`."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in TENSOR_FIELDS}
        )


def scene_from_arrays(fields: dict, flags: dict) -> Scene:
    """Build a Scene from numpy arrays keyed by field name (for instance
    `np.asarray` of every leaf of a JAX Scene) and a dict of the boolean
    flags. Arrays are converted to the port's dtypes."""
    tensors = {
        k: torch.tensor(np.asarray(fields[k])).to(dt)
        for k, dt in TENSOR_FIELDS.items()
    }
    return Scene(**tensors, **{k: bool(flags[k]) for k in FLAG_FIELDS})


def bucket_size(n: int) -> int:
    """Round a table length up to a shared size bucket: <= 32 -> 32, then
    powers of two to 512, then multiples of 512. Dummy rows never hit and
    dummy material/texture rows are never referenced, so bucketing is
    invisible to the rendered image."""
    if n <= 32:
        return 32
    if n <= 512:
        return 1 << (n - 1).bit_length()
    return -(-n // 512) * 512


class SceneBuilder:
    """Host-side scene construction with explicit seeding."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._sph: list[tuple] = []  # (center, radius, mat_id)
        self._quads: list[tuple] = []  # (Q, u, v, mat_id)
        self._mats: list[tuple] = []  # (type, albedo3, fuzz, ior, tex_id)
        self._texs: list[tuple] = []  # (type, c0, c1, scale, image_id)
        self._images: list[np.ndarray] = []

    # ---- textures ------------------------------------------------------
    def solid_color(self, r, g, b) -> int:
        self._texs.append((TEX_SOLID, (r, g, b), (0, 0, 0), 0.0, 0))
        return len(self._texs) - 1

    def checker(self, scale, even, odd) -> int:
        """3D solid checker over the hit point."""
        self._texs.append((TEX_CHECKER, tuple(even), tuple(odd), float(scale), 0))
        return len(self._texs) - 1

    def image(self, img: np.ndarray) -> int:
        """`img` is (H, W, 3) float in [0, 1]; texels are quantized to 8-bit
        steps (k/255) at build time, as the JAX builder does."""
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"image must be (H, W, 3), got {img.shape}")
        img = np.clip(np.round(img * 255.0), 0.0, 255.0) * np.float32(1.0 / 255.0)
        self._images.append(img)
        self._texs.append((TEX_IMAGE, (0, 0, 0), (0, 0, 0), 0.0, len(self._images) - 1))
        return len(self._texs) - 1

    def noise(self, scale) -> int:
        """Marble noise texture."""
        self._texs.append((TEX_NOISE, (0, 0, 0), (0, 0, 0), float(scale), 0))
        return len(self._texs) - 1

    # ---- materials -----------------------------------------------------
    def _resolve_tex(self, albedo) -> int:
        """Accept either a texture id or an RGB tuple (implicit solid)."""
        if isinstance(albedo, (int, np.integer)):
            return int(albedo)
        r, g, b = albedo
        return self.solid_color(r, g, b)

    def lambertian(self, albedo) -> int:
        tex = self._resolve_tex(albedo)
        self._mats.append((LAMBERTIAN, (0, 0, 0), 0.0, 1.0, tex))
        return len(self._mats) - 1

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        self._mats.append((METAL, tuple(albedo), float(fuzz), 1.0, 0))
        return len(self._mats) - 1

    def dielectric(self, ior: float) -> int:
        self._mats.append((DIELECTRIC, (0, 0, 0), 0.0, float(ior), 0))
        return len(self._mats) - 1

    def diffuse_light(self, emit) -> int:
        tex = self._resolve_tex(emit)
        self._mats.append((DIFFUSE_LIGHT, (0, 0, 0), 0.0, 1.0, tex))
        return len(self._mats) - 1

    # ---- geometry ------------------------------------------------------
    def add_sphere(self, center, radius, mat_id: int):
        self._sph.append((tuple(center), float(radius), int(mat_id)))

    def add_quad(self, q, u, v, mat_id: int):
        self._quads.append((tuple(q), tuple(u), tuple(v), int(mat_id)))

    def add_box(self, a, b, mat_id: int):
        """Axis-aligned box = 6 quads."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        mn = np.minimum(a, b)
        mx = np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0], np.float32)
        dy = np.array([0, mx[1] - mn[1], 0], np.float32)
        dz = np.array([0, 0, mx[2] - mn[2]], np.float32)
        self.add_quad((mn[0], mn[1], mx[2]), dx, dy, mat_id)  # front
        self.add_quad((mx[0], mn[1], mx[2]), -dz, dy, mat_id)  # right
        self.add_quad((mx[0], mn[1], mn[2]), -dx, dy, mat_id)  # back
        self.add_quad((mn[0], mn[1], mn[2]), dz, dy, mat_id)  # left
        self.add_quad((mn[0], mx[1], mx[2]), dx, -dz, mat_id)  # top
        self.add_quad((mn[0], mn[1], mn[2]), dx, dz, mat_id)  # bottom

    # ---- build ---------------------------------------------------------
    @tr.spanned("scene/build")
    def build(
        self,
        pad_spheres: int | None = None,
        pad_quads: int | None = None,
        bilinear_textures: bool = False,
        procedural_perlin: bool = True,
        bucket_shapes: bool = False,
    ) -> Scene:
        """Produce the Scene (CPU tensors). Padding and bucketing follow the
        JAX builder: dummy rows never hit and are never referenced."""
        sph = self._sph or [((0.0, 0.0, 0.0), 0.0, 0)]
        quads = self._quads or [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0)]
        mats = self._mats or [(LAMBERTIAN, (0, 0, 0), 0.0, 1.0, 0)]
        texs = self._texs or [(TEX_SOLID, (0, 0, 0), (0, 0, 0), 0.0, 0)]

        def pad_list(rows, target, dummy):
            if target is not None and target > len(rows):
                rows = rows + [dummy] * (target - len(rows))
            return rows

        dummy_sph = ((0.0, 0.0, 0.0), 0.0, 0)
        dummy_quad = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0)
        sph = pad_list(sph, pad_spheres, dummy_sph)
        quads = pad_list(quads, pad_quads, dummy_quad)
        if bucket_shapes:
            sph = pad_list(sph, bucket_size(len(sph)), dummy_sph)
            quads = pad_list(quads, bucket_size(len(quads)), dummy_quad)
            mats = pad_list(
                mats, bucket_size(len(mats)), (LAMBERTIAN, (0, 0, 0), 0.0, 1.0, 0)
            )
            texs = pad_list(
                texs, bucket_size(len(texs)), (TEX_SOLID, (0, 0, 0), (0, 0, 0), 0.0, 0)
            )

        if self._images:
            hmax = max(i.shape[0] for i in self._images)
            wmax = max(i.shape[1] for i in self._images)
            images = np.zeros((len(self._images), hmax, wmax, 3), np.float32)
            dims = np.zeros((len(self._images), 2), np.int32)
            for k, im in enumerate(self._images):
                images[k, : im.shape[0], : im.shape[1]] = im
                dims[k] = (im.shape[0], im.shape[1])
        else:
            images = np.zeros((1, 1, 1, 3), np.float32)
            dims = np.ones((1, 2), np.int32)

        if procedural_perlin:
            from raytracer_tpu_torch.materials.perlin_hash import build_tables

            perlin_vec, perlin_px, perlin_py, perlin_pz = build_tables()
        else:
            perlin_vec = self.rng.uniform(
                -1.0, 1.0, size=(PERLIN_POINT_COUNT, 3)
            ).astype(np.float32)
            perlin_px = self.rng.permutation(PERLIN_POINT_COUNT).astype(np.int32)
            perlin_py = self.rng.permutation(PERLIN_POINT_COUNT).astype(np.int32)
            perlin_pz = self.rng.permutation(PERLIN_POINT_COUNT).astype(np.int32)

        fields = {
            "sph_center": np.array([s[0] for s in sph], np.float32),
            "sph_radius": np.array([s[1] for s in sph], np.float32),
            "sph_mat": np.array([s[2] for s in sph], np.int32),
            "quad_q": np.array([q[0] for q in quads], np.float32),
            "quad_u": np.array([q[1] for q in quads], np.float32),
            "quad_v": np.array([q[2] for q in quads], np.float32),
            "quad_mat": np.array([q[3] for q in quads], np.int32),
            "mat_type": np.array([m[0] for m in mats], np.int32),
            "mat_albedo": np.array([m[1] for m in mats], np.float32),
            "mat_fuzz": np.array([m[2] for m in mats], np.float32),
            "mat_ior": np.array([m[3] for m in mats], np.float32),
            "mat_tex": np.array([m[4] for m in mats], np.int32),
            "tex_type": np.array([t[0] for t in texs], np.int32),
            "tex_c0": np.array([t[1] for t in texs], np.float32),
            "tex_c1": np.array([t[2] for t in texs], np.float32),
            "tex_scale": np.array([t[3] for t in texs], np.float32),
            "tex_image": np.array([t[4] for t in texs], np.int32),
            "images": images,
            "image_dims": dims,
            "perlin_vec": perlin_vec,
            "perlin_px": perlin_px,
            "perlin_py": perlin_py,
            "perlin_pz": perlin_pz,
        }
        tex_types_present = set(int(t[0]) for t in texs)
        flags = {
            "has_image": TEX_IMAGE in tex_types_present,
            "has_noise": TEX_NOISE in tex_types_present,
            "has_checker": TEX_CHECKER in tex_types_present,
            "bilinear_textures": bilinear_textures,
            "perlin_procedural": procedural_perlin,
        }
        return scene_from_arrays(fields, flags)
