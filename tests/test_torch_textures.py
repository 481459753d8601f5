"""The port's noise and image textures against the JAX package: Perlin noise
in both forms (procedural hash and gathered tables), turbulence and marble,
nearest-neighbour image lookup, sphere and quad UV, the texture table, and
resolve_and_shade on textured scenes fed the same winners and uniforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core.camera import camera_frame, camera_rays
from raytracer_tpu.geometry import intersect as jint
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.materials import materials as jmat
from raytracer_tpu.materials import perlin_hash as jph
from raytracer_tpu.materials import textures as jtex
from raytracer_tpu.materials.packed import primitive_resolve_table
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch.geometry import intersect as pint
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.materials import materials as pmat
from raytracer_tpu_torch.materials import packed as ppk
from raytracer_tpu_torch.materials import perlin_hash as pph
from raytracer_tpu_torch.materials import textures as ptex

torch.set_num_threads(1)

N = 4096


def port(jsc):
    return pscene.scene_from_arrays(
        {k: np.asarray(getattr(jsc, k)) for k in pscene.TENSOR_FIELDS},
        {k: getattr(jsc, k) for k in pscene.FLAG_FIELDS},
    )


def textured_scene(builder_cls, procedural=True):
    """Noise on a sphere and a quad, an image on a sphere and on a quad, a
    checker, a metal (read as solid) and an emitter."""
    b = builder_cls(4)
    img = np.random.default_rng(2).uniform(0, 1, (6, 10, 3))
    b.add_sphere((0, -100.5, -1), 100, b.lambertian(b.noise(3.0)))
    b.add_sphere((0, 0, -1), 0.5, b.lambertian(b.image(img)))
    b.add_sphere((-1.1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.add_sphere((1.1, 0.8, -1), 0.3, b.diffuse_light(b.noise(1.5)))
    b.add_quad((-2, -0.4, -2.5), (4, 0, 0), (0, 2, 0),
               b.lambertian(b.image(img[:4, :7])))
    b.add_quad((-1, -0.5, 0.5), (1, 0, 0), (0, 0, -1), b.lambertian(b.noise(5.0)))
    b.add_quad((1, -0.5, 0.5), (1, 0, 0), (0, 0, -1),
               b.lambertian(b.checker(0.2, (1, 0, 0), (0, 1, 0))))
    return b.build(procedural_perlin=procedural)


def perlin_args(jsc, psc):
    if jsc.perlin_procedural:
        return None
    return tuple(getattr(psc, k) for k in ("perlin_vec", "perlin_px", "perlin_py", "perlin_pz"))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(7)
    p = rng.uniform(-60, 60, (N, 3)) * rng.choice([1.0, 0.05], (N, 1))
    return p.astype(np.float32)


def test_hash_twins_match_numpy():
    """perm_u8 and grad_component on int64 words equal the NumPy uint32
    originals on every 8-bit input, exactly."""
    x = np.arange(256, dtype=np.uint32)
    xt = torch.arange(256, dtype=torch.int64)
    for axis in range(3):
        np.testing.assert_array_equal(ptex.perm_u8(axis, xt).numpy(), jph.perm_u8(axis, x))
        np.testing.assert_array_equal(ptex.grad_component(axis, xt).numpy(),
                                      jph.grad_component(axis, x))


def test_build_tables_equal_jax():
    """The port's copy of perlin_hash.build_tables() equals the JAX
    package's, array for array (dtype, shape and every value)."""
    for mine, theirs in zip(pph.build_tables(), jph.build_tables(), strict=True):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)


def marble_points(kind: str, n: int = 2048):
    """Seeded marble inputs (points, scales): `uniform` points of both
    signs; `lattice` points on and one float step either side of lattice
    planes (integers and their neighbours, negatives included, where floor
    and the & 255 wrap change); `large` coordinates past the 256-cell
    wrap, at large scales."""
    rng = np.random.default_rng({"uniform": 11, "lattice": 12, "large": 13}[kind])
    if kind == "uniform":
        p = rng.uniform(-40, 40, (n, 3))
        scale = rng.uniform(0.1, 8, n)
    elif kind == "lattice":
        p = rng.integers(-300, 300, (n, 3)).astype(np.float32)
        step = rng.integers(-1, 2, (n, 3))
        p = np.where(step < 0, np.nextafter(p, -np.inf), np.where(step > 0, np.nextafter(
            p, np.inf), p))
        scale = np.ones(n)
    else:
        p = rng.uniform(-5e3, 5e3, (n, 3))
        scale = rng.uniform(4, 64, n)
    return torch.from_numpy(p.astype(np.float32)), torch.from_numpy(scale.astype(np.float32))


@pytest.mark.parametrize("kind", ["uniform", "lattice", "large"])
def test_procedural_marble_equals_the_gathered_tables(kind):
    """The twin's procedural marble (the hash recomputed at every corner)
    equals its marble gathered from build_tables()' arrays bit for bit:
    the kernels' shared-memory tables, filled from the same hash, change
    no bit of a marble."""
    vec, px, py, pz = (torch.from_numpy(x) for x in pph.build_tables())
    p, scale = marble_points(kind)
    assert torch.equal(ptex.marble(p, scale, None), ptex.marble(p, scale, (vec, px, py, pz)))
    assert torch.equal(ptex.perlin_noise(p * scale[:, None], None),
                       ptex.perlin_noise(p * scale[:, None], (vec, px, py, pz)))


@pytest.mark.parametrize("procedural", [True, False])
def test_perlin_noise_and_turbulence_match_jax(points, procedural):
    """Noise and 7-octave turbulence on 4096 points (tolerance 1e-6
    absolute; measured equal), for the procedural hash and for gathered
    rng tables (the form that sends a JAX scene to the wavefront-step
    kernel)."""
    jsc = textured_scene(jscene.SceneBuilder, procedural)
    psc = port(jsc)
    perlin = perlin_args(jsc, psc)
    p = torch.from_numpy(points)
    np.testing.assert_allclose(ptex.perlin_noise(p, perlin).numpy(),
                               np.asarray(jtex.perlin_noise(jsc, jnp.asarray(points))), atol=1e-6)
    np.testing.assert_allclose(ptex.perlin_turbulence(p, perlin).numpy(),
                               np.asarray(jtex.perlin_turbulence(jsc, jnp.asarray(points))),
                               atol=1e-6)


@pytest.mark.parametrize("procedural", [True, False])
def test_marble_matches_jax_eval_texture(points, procedural):
    """The marble value against eval_texture_packed's noise branch (1e-6
    absolute: the two libraries' sin may differ by an ulp)."""
    jsc = textured_scene(jscene.SceneBuilder, procedural)
    psc = port(jsc)
    scale = np.random.default_rng(1).uniform(0.5, 6, N).astype(np.float32)
    ref = jtex.eval_texture_packed(
        jsc, jnp.full(N, jscene.TEX_NOISE, jnp.float32), jnp.zeros((N, 3)), jnp.zeros((N, 3)),
        jnp.asarray(scale), jnp.zeros(N), jnp.zeros(N), jnp.zeros(N), jnp.asarray(points))
    got = ptex.marble(torch.from_numpy(points), torch.from_numpy(scale), perlin_args(jsc, psc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 0], atol=1e-6)


@pytest.mark.parametrize("name", ["earth", "textured"])
def test_image_lookup_matches_jax(name):
    """Nearest-neighbour lookup on the earth texture and on the textured
    scene's two padded images, u and v beyond [0, 1] included: equal."""
    jsc = jax_get_scene("earth", width=16)[0] if name == "earth" else textured_scene(jscene.SceneBuilder)
    psc = port(jsc)
    rng = np.random.default_rng(5)
    u = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    u[:4], v[:4] = [0, 1, 1, 0], [0, 0, 1, 1]
    img_id = rng.integers(0, psc.images.shape[0], N)
    ref = jtex._image_lookup(jsc, jnp.asarray(img_id, jnp.int32), jnp.asarray(u), jnp.asarray(v))
    got = ptex.image_lookup(psc.images, psc.image_dims, torch.from_numpy(img_id),
                            torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sphere_and_quad_uv_match_jax():
    """sphere_uv against _sphere_uv on random unit normals, and quad_uv
    against resolve_hits' quad (u, v) on hits of the textured scene's quads
    (both within 1e-6 absolute: acos/atan2 and dot-product order)."""
    rng = np.random.default_rng(9)
    nrm = rng.normal(size=(N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ju, jv = jint._sphere_uv(jnp.asarray(nrm))
    pu, pv = pint.sphere_uv(torch.from_numpy(nrm))
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)

    jsc = textured_scene(jscene.SceneBuilder)
    psc = port(jsc)
    o = np.tile(np.float32([[0.1, 0.6, 2.0]]), (N, 1))
    d = (rng.uniform([-2, -0.6, -2.5], [2, 1.6, -2.5], (N, 3)) - o).astype(np.float32)
    hit = jint.intersect_scene(jsc, jnp.asarray(o), jnp.asarray(d))
    prim = np.asarray(hit.prim_id)
    on_quad = np.asarray(hit.hit) & (prim >= psc.num_spheres)
    assert on_quad.mean() > 0.5
    qd = pint.quad_derived(psc)
    q = torch.from_numpy(prim[on_quad] - psc.num_spheres).long()
    u, v = pint.quad_uv(torch.from_numpy(np.asarray(hit.point)[on_quad]), qd.av[q], qd.q_av[q],
                        qd.bv[q], qd.q_bv[q])
    np.testing.assert_allclose(u.numpy(), np.asarray(hit.u)[on_quad], atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(hit.v)[on_quad], atol=1e-6)


def test_texture_table_columns():
    """The texture table against the JAX resolve table's texture and quad
    basis columns; scenes without noise or image get no table."""
    from raytracer_tpu.materials import packed as jpk

    jsc = textured_scene(jscene.SceneBuilder)
    psc = port(jsc)
    tt = ppk.texture_tables(psc, pint.quad_derived(psc))
    ref = np.asarray(primitive_resolve_table(jsc, jint.quad_derived(jsc)))
    rows = tt.rows.numpy()
    for got, want in ((ppk.TCOL_TYPE, jpk.COL_TTYPE), (ppk.TCOL_SCALE, jpk.COL_TSCALE),
                      (ppk.TCOL_IMAGE, jpk.COL_TIMAGE)):
        np.testing.assert_array_equal(rows[:, got], ref[:, want])
    ns = psc.num_spheres
    np.testing.assert_allclose(rows[ns:, ppk.TCOL_AV], ref[ns:, jpk.COL_Q_AV], rtol=1e-6)
    np.testing.assert_allclose(rows[ns:, ppk.TCOL_BV], ref[ns:, jpk.COL_Q_BV], rtol=1e-6)
    np.testing.assert_allclose(rows[ns:, ppk.TCOL_QAV], ref[ns:, jpk.COL_Q_QAV], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rows[ns:, ppk.TCOL_QBV], ref[ns:, jpk.COL_Q_QBV], rtol=1e-6, atol=1e-7)
    assert tt.has_image and tt.has_noise and tt.perlin is None
    rs = pscene.scene_from_arrays(
        {k: np.asarray(getattr(jax_get_scene("rand_spheres", width=8)[0], k))
         for k in pscene.TENSOR_FIELDS},
        {k: False for k in pscene.FLAG_FIELDS})
    assert ppk.texture_tables(rs, pint.quad_derived(rs)) is None


def scenes(name):
    if name in ("textured", "textured_tables"):
        jsc = textured_scene(jscene.SceneBuilder, procedural=name == "textured")
        from raytracer_tpu.core.camera import make_camera

        cam, _ = make_camera(16 / 9, 64, look_from=(0, 0.5, 2), look_at=(0, 0, -1),
                             fov_degrees=70)
        return jsc, cam, 64, 36
    jsc, cam, st = jax_get_scene(name, width=64)
    return jsc, cam, st.width, st.height


@pytest.mark.parametrize("name", ["perlin", "earth", "simple_light", "textured",
                                  "textured_tables"])
def test_resolve_and_shade_with_textures_matches_jax(name):
    """The port's resolve_and_shade with its texture table against the JAX
    resolve_and_shade, same winners, rays and uniforms (rtol/atol 1e-5, as
    tests/test_torch_shade.py; the hit, scatter flag and every field of
    every hit lane)."""
    jsc, cam, w, h = scenes(name)
    psc = port(jsc)
    rng = np.random.default_rng(8)
    pix = rng.integers(0, w * h, N)
    o, d = camera_rays(camera_frame(cam, w, h), jnp.asarray(pix % w), jnp.asarray(pix // w),
                       jnp.asarray(rng.uniform(0, 1, (N, 4)).astype(np.float32)))
    t, prim = jint.closest_hit_t_prim(jsc, o, d)
    uni = rng.uniform(0, 1, (N, jmat.UNIFORMS_PER_BOUNCE)).astype(np.float32)
    ref = jmat.resolve_and_shade(jsc, primitive_resolve_table(jsc, jint.quad_derived(jsc)),
                                 t, prim, o, d, jnp.asarray(uni))
    qd = pint.quad_derived(psc)
    got = pmat.resolve_and_shade(
        ppk.primitive_table(psc, qd), psc.num_spheres, torch.tensor(np.asarray(t)),
        torch.tensor(np.asarray(prim)), torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        torch.from_numpy(uni), ppk.texture_tables(psc, qd),
    )
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(got.scattered.numpy()[hit], np.asarray(ref.scattered)[hit])
    for f in ("point", "direction", "attenuation", "emitted"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
