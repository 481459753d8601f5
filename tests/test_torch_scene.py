"""The PyTorch port's scene data against the JAX package: every Scene field,
camera field and render setting of every registry scene is exactly equal,
and the builder's padding / bucketing / texture rules match."""

import numpy as np
import pytest
import torch

from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.scenes.registry import SCENES as JAX_SCENES
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch.core.camera import CAMERA_FIELDS
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.scenes.registry import SCENES, get_scene

torch.set_num_threads(1)


def assert_scene_equal(port, jax_scene):
    for name, dtype in pscene.TENSOR_FIELDS.items():
        got = getattr(port, name)
        assert got.dtype == dtype, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jax_scene, name)), err_msg=name)
    for name in pscene.FLAG_FIELDS:
        assert getattr(port, name) == getattr(jax_scene, name), name


def test_registry_names_match():
    assert sorted(SCENES) == sorted(JAX_SCENES)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_registry_scene_equals_jax(name, bucket):
    kw = dict(width=32, bucket=bucket)
    jsc, jcam, jset = jax_get_scene(name, 3, **kw)
    psc, pcam, pset = get_scene(name, 3, **kw)
    assert_scene_equal(psc, jsc)
    for f in CAMERA_FIELDS:
        got = getattr(pcam, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jcam, f)), err_msg=f)
    assert tuple(pset) == tuple(jset)


def _build_both(fn, **build_kw):
    pb, jb = pscene.SceneBuilder(5), jscene.SceneBuilder(5)
    fn(pb)
    fn(jb)
    return pb.build(**build_kw), jb.build(**build_kw)


def _textured(b):
    rng = np.random.default_rng(2)
    img_a = b.image(rng.uniform(0, 1, (5, 7, 3)))
    img_b = b.image(rng.uniform(0, 1, (3, 9, 3)))
    b.add_sphere((0, 0, 0), 1.0, b.lambertian(img_a))
    b.add_sphere((1, 2, 3), -0.5, b.diffuse_light(img_b))
    b.add_quad((0, 0, 0), (1, 0, 0), (0, 1, 0), b.lambertian(b.noise(3.0)))
    b.add_box((0, 0, 0), (1, 2, 3), b.metal((0.5, 0.6, 0.7), 0.2))
    b.add_sphere((2, 2, 2), 0.3, b.lambertian(b.checker(0.5, (1, 0, 0), (0, 1, 0))))


@pytest.mark.parametrize(
    "build_kw",
    [
        {},
        {"pad_spheres": 9, "pad_quads": 13},
        {"bucket_shapes": True, "bilinear_textures": True},
        {"procedural_perlin": False},
    ],
)
def test_builder_matches_jax(build_kw):
    """Images (8-bit quantized, padded), noise, checker, box quads, padding,
    bucketing and both Perlin table constructions."""
    port, ref = _build_both(_textured, **build_kw)
    assert_scene_equal(port, ref)


def test_empty_builder_dummy_rows():
    port, ref = _build_both(lambda b: None)
    assert_scene_equal(port, ref)
    assert float(port.sph_radius[0]) == 0.0  # dummy sphere never hits
    assert float(port.quad_u.abs().sum() + port.quad_v.abs().sum()) == 0.0


def test_bucket_size_matches_jax():
    for n in list(range(1, 1100)) + [4095, 4096, 4097, 10001]:
        assert pscene.bucket_size(n) == jscene.bucket_size(n), n


def test_scene_from_arrays_and_to_roundtrip():
    jsc, _, _ = jax_get_scene("cornell", width=16)
    fields = {k: np.asarray(getattr(jsc, k)) for k in pscene.TENSOR_FIELDS}
    flags = {k: getattr(jsc, k) for k in pscene.FLAG_FIELDS}
    port = pscene.scene_from_arrays(fields, flags).to("cpu")
    assert_scene_equal(port, jsc)
    assert port.num_prims == jsc.num_spheres + jsc.num_quads


@pytest.mark.parametrize("which", ["earth", "perlin", "textured_rng_tables"])
def test_scene_from_arrays_carries_textures(which):
    """The texture fields cross over exactly: images and their true dims,
    the Perlin tables with procedural_perlin True and False, texture
    scales and image ids."""
    if which == "textured_rng_tables":
        ref = _build_both(_textured, procedural_perlin=False)[1]
    else:
        ref = jax_get_scene(which, width=16)[0]
    fields = {k: np.asarray(getattr(ref, k)) for k in pscene.TENSOR_FIELDS}
    port = pscene.scene_from_arrays(fields, {k: getattr(ref, k) for k in pscene.FLAG_FIELDS})
    assert_scene_equal(port, ref)
    for k in ("images", "image_dims", "perlin_vec", "perlin_px", "perlin_py", "perlin_pz",
              "tex_scale", "tex_image"):
        np.testing.assert_array_equal(getattr(port, k).numpy(), fields[k], err_msg=k)
    assert port.perlin_procedural == (which != "textured_rng_tables")
    assert port.has_image == (which != "perlin") and port.has_noise == (which != "earth")
