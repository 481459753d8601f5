"""Per-primitive material row table: one indexed row read per hit.

Port of the resolve-table half of raytracer_tpu/materials/packed.py and
ops/persistent_kernel.py:pack_persistent_tables. The two-level indirection
primitive -> material -> texture resolves on the host into one (P, 16)
float32 row per primitive (spheres first, then quads, matching prim ids).
The kernel reads the winner's row directly by index as four float4; this
plain (P, cols) layout replaces the TPU's lane-replicated resolve table,
which existed only to feed a lane-gather scan.

The (P, 16) table carries solid and checker textures. Noise and image
textures need fields that do not fit its spare columns (the quad UV basis
alone is eight floats), so they go in a second (P, TEX_COLS) table beside
it (`texture_tables`), built only for scenes that have such textures, with
the scene's float32 (I, H, W, 3) texels and (I, 2) true dims: the (P, 16)
layout does not change, and the textured instantiations of kernels 2 and 3
read those same tensors, so kernel and twin fetch identical texels. The TPU
kernel's f32-mantissa texel packing (pack_image_table) and its texel
chunk-band scan were Mosaic workarounds and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.geometry.scene import METAL, TEX_CHECKER, TEX_SOLID

# Column layout (four float4 per row).
COL_G = slice(0, 3)  # sphere center | quad unit normal
COL_G3 = 3  # sphere signed radius (hollow glass: negative) | 0 for quads
COL_MTYPE = 4  # material type enum, as float
COL_PRM = 5  # metal fuzz | ior
COL_C0 = slice(6, 9)  # metal albedo | solid color | checker even color
COL_C1 = slice(9, 12)  # checker odd color
COL_ITS = 12  # 1 / checker scale; 0 = solid
N_COLS = 16


def _shading_cols(scene, mat_id):
    mtype = scene.mat_type[mat_id]
    tex = scene.mat_tex[mat_id]
    ttype = scene.tex_type[tex]
    is_metal = mtype == METAL
    c0 = torch.where(is_metal[:, None], scene.mat_albedo[mat_id], scene.tex_c0[tex])
    c1 = scene.tex_c1[tex]
    is_checker = (ttype == TEX_CHECKER) & ~is_metal
    scale = scene.tex_scale[tex]
    safe = torch.where(scale != 0.0, scale, torch.ones_like(scale))
    its = torch.where(is_checker, 1.0 / safe, torch.zeros_like(scale))
    prm = torch.where(is_metal, scene.mat_fuzz[mat_id], scene.mat_ior[mat_id])
    return mtype.to(torch.float32), prm, c0, c1, its


def primitive_table(scene, qd) -> torch.Tensor:
    """(P, N_COLS) float32 rows, spheres then quads. `qd` is
    geometry.intersect.quad_derived(scene)."""
    mt_s, prm_s, c0_s, c1_s, its_s = _shading_cols(scene, scene.sph_mat.long())
    mt_q, prm_q, c0_q, c1_q, its_q = _shading_cols(scene, scene.quad_mat.long())
    r = scene.sph_radius
    p = scene.num_prims
    table = torch.zeros(p, N_COLS, dtype=torch.float32, device=r.device)
    table[:, COL_G] = torch.cat([scene.sph_center, qd.normal])
    table[:, COL_G3] = torch.cat([r, torch.zeros_like(qd.d)])
    table[:, COL_MTYPE] = torch.cat([mt_s, mt_q])
    table[:, COL_PRM] = torch.cat([prm_s, prm_q])
    table[:, COL_C0] = torch.cat([c0_s, c0_q])
    table[:, COL_C1] = torch.cat([c1_s, c1_q])
    table[:, COL_ITS] = torch.cat([its_s, its_q])
    return table


# Texture table layout (three float4 per row).
TCOL_TYPE = 0  # texture type enum, as float (solid for metals)
TCOL_SCALE = 1  # noise scale
TCOL_IMAGE = 2  # image index, as float
TCOL_AV = slice(4, 7)  # quad alpha basis (v x w); 0 for spheres
TCOL_QAV = 7  # Q.av
TCOL_BV = slice(8, 11)  # quad beta basis (w x u)
TCOL_QBV = 11  # Q.bv
TEX_COLS = 12

# Image filter modes (csrc/textures.cuh keeps the same values).
FILTER_NEAREST = 0
FILTER_BILINEAR = 1  # the deterministic 4-tap filter
FILTER_STOCHASTIC = 2  # one tap drawn with its bilinear weight


class TextureTables(NamedTuple):
    """What noise and image shading reads beside the (P, 16) table."""

    rows: torch.Tensor  # (P, TEX_COLS) float32
    images: torch.Tensor  # (I, H, W, 3) float32
    image_dims: torch.Tensor  # (I, 2) int32, true (H, W)
    perlin: tuple | None  # (vec, px, py, pz) gathered tables; None = procedural
    has_image: bool
    has_noise: bool
    image_filter: int  # FILTER_*


def texture_tables(scene, qd, stochastic: bool = False) -> TextureTables | None:
    """The texture table of a scene with noise or image textures (None
    otherwise), on the scene's device. Metals read as solid, as in the JAX
    package's primitive_shading_table. Images filter nearest-neighbour, or
    bilinear when `scene.bilinear_textures`: the stochastic single tap with
    `stochastic` (the persistent render's default), else the 4-tap."""
    if not (scene.has_noise or scene.has_image):
        return None
    mat_id = torch.cat([scene.sph_mat, scene.quad_mat]).long()
    tex = scene.mat_tex[mat_id].long()
    ttype = torch.where(scene.mat_type[mat_id] == METAL, TEX_SOLID, scene.tex_type[tex])
    ns = scene.num_spheres
    rows = torch.zeros(scene.num_prims, TEX_COLS, dtype=torch.float32, device=mat_id.device)
    rows[:, TCOL_TYPE] = ttype.to(torch.float32)
    rows[:, TCOL_SCALE] = scene.tex_scale[tex]
    rows[:, TCOL_IMAGE] = scene.tex_image[tex].to(torch.float32)
    rows[ns:, TCOL_AV] = qd.av
    rows[ns:, TCOL_QAV] = qd.q_av
    rows[ns:, TCOL_BV] = qd.bv
    rows[ns:, TCOL_QBV] = qd.q_bv
    perlin = None
    if not scene.perlin_procedural:
        perlin = (scene.perlin_vec, scene.perlin_px, scene.perlin_py, scene.perlin_pz)
    if not scene.bilinear_textures:
        filt = FILTER_NEAREST
    else:
        filt = FILTER_STOCHASTIC if stochastic else FILTER_BILINEAR
    return TextureTables(rows, scene.images.contiguous(), scene.image_dims.contiguous(), perlin,
                         bool(scene.has_image), bool(scene.has_noise), filt)
