"""Pinhole + thin-lens camera (port of raytracer_tpu/core/camera.py).

The derived frame is computed in float32 exactly as the JAX package does: a
float64 frame would shift every ray by float32 rounding and the port would no
longer trace the reference's rays.

Layout convention: pixel (i, j) = (column, row), row 0 at the top.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.core.sampling import unit_disk_from_uniform

CAMERA_FIELDS = (
    "look_from",  # (3,)
    "look_at",  # (3,)
    "vup",  # (3,)
    "fov_radians",  # ()
    "defocus_angle_radians",  # ()
    "focus_dist",  # ()
    "background",  # (3,) flat background color
    "aspect",  # () W/H aspect; sizes the viewport from the float height
)


@dataclass
class Camera:
    """Camera parameters, all float32 CPU tensors."""

    look_from: torch.Tensor
    look_at: torch.Tensor
    vup: torch.Tensor
    fov_radians: torch.Tensor
    defocus_angle_radians: torch.Tensor
    focus_dist: torch.Tensor
    background: torch.Tensor
    aspect: torch.Tensor


class RenderSettings(NamedTuple):
    """Static render configuration. `sky_gradient` selects the lerp sky
    instead of the flat background color."""

    width: int
    height: int
    samples_per_pixel: int = 100
    max_depth: int = 50
    sky_gradient: bool = False


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def camera_from_arrays(fields: dict) -> Camera:
    """Camera from numpy-convertible values keyed by field name (for instance
    `np.asarray` of each field of a JAX Camera)."""
    return Camera(**{k: _f32(fields[k]) for k in CAMERA_FIELDS})


def image_height_for(aspect_ratio: float, image_width: int) -> int:
    """Integer image height: floor(W)/aspect truncated, at least 1."""
    h = math.floor(float(image_width)) / float(aspect_ratio)
    return max(1, int(h))


def make_camera(
    aspect_ratio: float,
    image_width: int,
    *,
    samples_per_pixel: int = 100,
    max_depth: int = 50,
    fov_degrees: float = 90.0,
    look_from=(0.0, 0.0, -1.0),
    look_at=(0.0, 0.0, 0.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle_degrees: float = 0.0,
    focus_dist: float = 10.0,
    background=(0.0, 0.0, 0.0),
    sky_gradient: bool = False,
) -> tuple[Camera, RenderSettings]:
    """Build (Camera, RenderSettings); the same defaults as the JAX package."""
    cam = Camera(
        look_from=_f32(look_from),
        look_at=_f32(look_at),
        vup=_f32(vup),
        fov_radians=_f32(math.radians(fov_degrees)),
        defocus_angle_radians=_f32(math.radians(defocus_angle_degrees)),
        focus_dist=_f32(focus_dist),
        background=_f32(background),
        aspect=_f32(aspect_ratio),
    )
    settings = RenderSettings(
        width=int(image_width),
        height=image_height_for(aspect_ratio, image_width),
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        sky_gradient=sky_gradient,
    )
    return cam, settings


@dataclass
class CameraFrame:
    """Derived camera state, float32 tensors."""

    center: torch.Tensor  # (3,)
    pixel00: torch.Tensor  # (3,)
    pixel_du: torch.Tensor  # (3,)
    pixel_dv: torch.Tensor  # (3,)
    defocus_disk_u: torch.Tensor  # (3,)
    defocus_disk_v: torch.Tensor  # (3,)
    defocus_angle_radians: torch.Tensor  # ()

    def to(self, device) -> "CameraFrame":
        """The frame on `device`, its fields moved as one flat tensor: one
        copy (one host sync from the CPU to a card, not one a field), each
        field a view of it, differentiable like the fields' own moves."""
        fields = [getattr(self, f.name) for f in dataclasses.fields(self)]
        flat = torch.cat([x.reshape(-1) for x in fields]).to(device)
        parts = flat.split([x.numel() for x in fields])
        return dataclasses.replace(self, **{
            f.name: p.reshape(x.shape)
            for f, p, x in zip(dataclasses.fields(self), parts, fields)})


def camera_frame(cam: Camera, width: int, height: int) -> CameraFrame:
    """Compute the derived frame in float32. The viewport and pixel_dv use
    the float image height floor(W)/aspect, as the JAX package does."""
    center = cam.look_from
    w = vm.normalize(cam.look_from - cam.look_at)
    u = vm.normalize(vm.cross(cam.vup, w))
    v = vm.cross(w, u)

    h = torch.tan(cam.fov_radians / 2.0)
    viewport_h = 2.0 * h * cam.focus_dist
    float_h = torch.clamp(float(width) / cam.aspect, min=1.0)
    viewport_w = viewport_h * (float(width) / float_h)

    viewport_u = u * viewport_w
    viewport_v = -v * viewport_h
    pixel_du = viewport_u / float(width)
    pixel_dv = viewport_v / float_h

    upper_left = center - cam.focus_dist * w - 0.5 * viewport_u - 0.5 * viewport_v
    pixel00 = upper_left + 0.5 * (pixel_du + pixel_dv)

    defocus_radius = cam.focus_dist * torch.tan(cam.defocus_angle_radians / 2.0)
    return CameraFrame(
        center=center,
        pixel00=pixel00,
        pixel_du=pixel_du,
        pixel_dv=pixel_dv,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle_radians=cam.defocus_angle_radians,
    )


def camera_rays(frame: CameraFrame, px, py, uniforms):
    """One primary ray per lane.

    px, py: (N,) int pixel coordinates (column, row); uniforms: (N, 4)
    U[0,1) — [jitter x, jitter y] then two for the defocus disk. Returns
    (origin (N, 3), direction (N, 3)); the direction is unnormalized."""
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    dx = uniforms[..., 0] - 0.5
    dy = uniforms[..., 1] - 0.5
    pixel_center = (
        frame.pixel00
        + (px + dx)[..., None] * frame.pixel_du
        + (py + dy)[..., None] * frame.pixel_dv
    )
    disk = unit_disk_from_uniform(uniforms[..., 2:4])
    lens_origin = (
        frame.center
        + disk[..., 0:1] * frame.defocus_disk_u
        + disk[..., 1:2] * frame.defocus_disk_v
    )
    if float(frame.defocus_angle_radians) > 0.0:
        origin = lens_origin
    else:
        origin = frame.center.expand_as(lens_origin)
    direction = pixel_center - origin
    return origin, direction
