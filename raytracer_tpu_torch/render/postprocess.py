"""Color pipeline: averaged linear radiance -> gamma 2 -> 8-bit RGB (port of
raytracer_tpu/render/postprocess.py)."""

from __future__ import annotations

import torch

from raytracer_tpu_torch.utils import trace as tr


def to_gamma2(rgb):
    """sqrt tonemap of non-negative linear radiance."""
    return torch.sqrt(torch.clamp(rgb, min=0.0))


def to_u8(rgb_linear):
    """Gamma 2, clamp to [0, 1], scale by 255.999, truncate; a root span
    `to_u8` of utils/trace.py."""
    with tr.span("to_u8"):
        scaled = torch.clamp(to_gamma2(rgb_linear), 0.0, 1.0) * 255.999
        return scaled.to(torch.uint8)
