"""The port's closest hit (the plain twin of its CUDA kernel) against the JAX
package's dense `closest_hit_t_prim` and its Pallas kernel `intersect_pallas`
(interpret mode on the CPU, as tests/test_intersect.py runs it), on random
and camera rays over rand_spheres' and cornell's tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core.camera import camera_frame, camera_rays
from raytracer_tpu.geometry import intersect as jint
from raytracer_tpu.ops import intersect_kernel as jik
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch.geometry import intersect as pint
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.ops import intersect_kernel as pik

torch.set_num_threads(1)

BOXES = {
    "rand_spheres": ((-12.0, 0.05, -12.0), (12.0, 6.0, 12.0)),
    "cornell": ((1.0, 1.0, 1.0), (554.0, 554.0, 554.0)),
}


def port_scene(jax_scene):
    return pscene.scene_from_arrays(
        {k: np.asarray(getattr(jax_scene, k)) for k in pscene.TENSOR_FIELDS},
        {k: getattr(jax_scene, k) for k in pscene.FLAG_FIELDS},
    )


def rays(name, n, seed):
    """Half random box-to-box rays, half jittered camera rays."""
    jsc, jcam, js = jax_get_scene(name, width=64)
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(b, np.float32) for b in BOXES[name])
    m = n // 2
    o = rng.uniform(lo, hi, (m, 3)).astype(np.float32)
    d = (rng.uniform(lo, hi, (m, 3)).astype(np.float32) - o).astype(np.float32)
    pix = rng.integers(0, js.width * js.height, n - m)
    co, cd = camera_rays(
        camera_frame(jcam, js.width, js.height),
        jnp.asarray(pix % js.width), jnp.asarray(pix // js.width),
        jnp.asarray(rng.uniform(0, 1, (n - m, 4)).astype(np.float32)),
    )
    o = np.concatenate([o, np.asarray(co)])
    d = np.concatenate([d, np.asarray(cd)])
    return jsc, o, d


def assert_agree(t_p, p_p, t_ref, p_ref, what):
    """prim equal on >= 99.9% of rays; t within rtol 1e-5 where it is."""
    same = p_p == p_ref
    assert same.mean() >= 0.999, (what, same.mean())
    fin = same & np.isfinite(t_ref)
    assert fin.sum() > 100, what
    np.testing.assert_allclose(t_p[fin], t_ref[fin], rtol=1e-5, err_msg=what)
    assert np.array_equal(np.isinf(t_p[same]), np.isinf(t_ref[same])), what


@pytest.mark.parametrize("name", ["rand_spheres", "cornell"])
def test_closest_hit_matches_jax_dense(name):
    jsc, o, d = rays(name, 8192, seed=1)
    t_j, p_j = jint.closest_hit_t_prim(jsc, jnp.asarray(o), jnp.asarray(d))
    t_j, p_j = np.asarray(t_j), np.asarray(p_j)
    p_j = np.where(np.isfinite(t_j), p_j, -1)  # JAX's argmin over all-inf rows
    t_p, p_p = pint.closest_hit_t_prim(port_scene(jsc), torch.from_numpy(o), torch.from_numpy(d))
    assert t_p.dtype == torch.float32 and p_p.dtype == torch.int32
    assert_agree(t_p.numpy(), p_p.numpy(), t_j, p_j, f"{name} vs dense")
    assert (p_p.numpy() >= 0).mean() > 0.3  # the rays do hit things


@pytest.mark.parametrize("name", ["rand_spheres", "cornell"])
def test_closest_hit_matches_pallas_kernel(name):
    """prim equal on >= 99.9% of rays. t within rtol 1e-5 of the Pallas
    kernel wherever the JAX package's own dense path is; elsewhere no
    farther from it than that dense path. (The expanded |o - c|^2 sphere
    formula loses ~5 digits in float32: the JAX package's interpreted
    Pallas kernel and its dense path themselves differ by more than rtol
    1e-5 on ~8% of these rays, up to 1.6e-3, while the port and the dense
    path agree to 3e-6.)"""
    jsc, o, d = rays(name, 2048, seed=2)
    sph = jik.pack_sphere_table(jsc.sph_center, jsc.sph_radius)
    quad = jik.pack_quad_table(jint.quad_derived(jsc))
    with pltpu.force_tpu_interpret_mode():
        t_k, p_k = jik.intersect_pallas(sph, quad, jnp.asarray(o), jnp.asarray(d), rows=8)
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    t_j = np.asarray(jint.closest_hit_t_prim(jsc, jnp.asarray(o), jnp.asarray(d))[0])
    psc = port_scene(jsc)
    psph, pquad = pint.scene_tables(psc)
    np.testing.assert_allclose(psph.numpy(), np.asarray(sph), rtol=1e-6)
    np.testing.assert_allclose(pquad.numpy(), np.asarray(quad), rtol=1e-6, atol=1e-6)
    # The wrapper on CPU tensors is the plain twin.
    t_p, p_p = pik.intersect(psph, pquad, torch.from_numpy(o), torch.from_numpy(d))
    t_p, p_p = t_p.numpy(), p_p.numpy()
    same = p_p == p_k
    assert same.mean() >= 0.999, same.mean()
    fin = same & np.isfinite(t_k)
    assert fin.sum() > 100
    assert np.array_equal(np.isinf(t_p[same]), np.isinf(t_k[same]))
    err_port = np.abs(t_p[fin] - t_k[fin])
    err_dense = np.abs(t_j[fin] - t_k[fin])
    bound = 1e-5 * np.abs(t_k[fin])
    assert np.all(err_port <= np.maximum(bound, err_dense + bound))
    consistent = err_dense <= bound
    assert consistent.mean() > 0.85
    np.testing.assert_allclose(t_p[fin][consistent], t_k[fin][consistent], rtol=1e-5)


def test_intersect_scene_epilogue_matches_jax():
    jsc, o, d = rays("rand_spheres", 4096, seed=3)
    ref = jint.intersect_scene(jsc, jnp.asarray(o), jnp.asarray(d))
    got = pint.intersect_scene(port_scene(jsc), torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(ref.hit)
    assert (got.hit.numpy() == hit).mean() > 0.999
    both = hit & got.hit.numpy() & (got.prim_id.numpy() == np.asarray(ref.prim_id))
    for f in ("point", "normal"):
        np.testing.assert_allclose(
            getattr(got, f).numpy()[both], np.asarray(getattr(ref, f))[both], rtol=1e-4, atol=1e-4,
            err_msg=f,
        )
    np.testing.assert_array_equal(got.front_face.numpy()[both], np.asarray(ref.front_face)[both])
    np.testing.assert_array_equal(got.mat_id.numpy()[both], np.asarray(ref.mat_id)[both])


def test_plain_twin_dummy_rows_and_ties():
    """Dummy rows never hit; on an exact tie the first primitive wins (the
    kernel's sequential strict `<`), spheres before quads."""
    b = pscene.SceneBuilder(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -5), 1.0, m)
    b.add_sphere((0, 0, -5), 1.0, m)  # duplicate: tie with row 0
    b.add_quad((-1, -1, -4), (2, 0, 0), (0, 2, 0), m)  # plane z=-4, same t as the spheres
    sc = b.build(pad_spheres=6, pad_quads=4)
    o = torch.zeros(3, 3)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 3.0, -1.0]])
    t, p = pint.closest_hit_t_prim(sc, o, d)
    assert p.tolist() == [0, -1, -1]
    assert float(t[0]) == pytest.approx(4.0, rel=1e-6)
    assert bool(torch.isinf(t[1:]).all())


def test_wrapper_validates_inputs():
    sph = torch.zeros(2, 4)
    quad = torch.zeros(1, 12)
    o = torch.zeros(5, 3)
    with pytest.raises(TypeError):
        pik.intersect(sph, quad, o.double(), o.double())
    with pytest.raises(ValueError):
        pik.intersect(sph, quad, o, torch.zeros(4, 3))
    with pytest.raises(ValueError):
        pik.intersect(torch.zeros(2, 5), quad, o, o)
    with pytest.raises(ValueError):
        pik.intersect(sph, quad, o, torch.zeros(3, 5).T)  # non-contiguous


def grazing_rays(centers, radii, eye, inset, n_phi=64):
    """float32 rays from `eye` through points a fraction `inset` of each
    sphere's radius inside its visible contour (float64 geometry), and
    the float64 centres and radii of the spheres they aim at."""
    c, r, e = (torch.as_tensor(x, dtype=torch.float64) for x in (centers, radii, eye))
    z = c - e
    dist = z.norm(dim=1, keepdim=True)
    zh = z / dist
    e1 = torch.linalg.cross(zh, torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64).expand_as(zh))
    e1 = e1 / e1.norm(dim=1, keepdim=True)
    e2 = torch.linalg.cross(zh, e1)
    phi = torch.arange(n_phi, dtype=torch.float64) * (2 * np.pi / n_phi)
    rho = (r * (1 - inset))[:, None, None]
    aim = c[:, None] + rho * (phi.cos()[None, :, None] * e1[:, None] + phi.sin()[None, :, None]
                             * e2[:, None])
    d = (aim - e).reshape(-1, 3)
    return (e.expand_as(d).float().contiguous(), d.float().contiguous(),
            c.repeat_interleave(n_phi, 0), r.repeat_interleave(n_phi, 0))


def test_stable_sphere_winners_lie_on_their_spheres():
    """Camera rays grazing small spheres far from the origin (rand_spheres'
    r = 0.2 at |c| ~ 12, the eye at (13, 2, 3)): with the radii, the twin's
    sphere winners lie on their spheres to 1e-5, where the folded |c|^2 -
    r^2 alone puts them 1e-4 or more inside; the winners are the same, and
    the ground sphere (r = 1000, whose fold is exactly 0) keeps the fold's
    t bit for bit."""
    centers = [[0.0, -1000.0, 0.0], [11.2, 0.2, 3.1], [-4.3, 0.2, 10.8], [7.6, 0.2, -8.9],
               [-11.5, 0.2, -1.7]]
    radii = [1000.0, 0.2, 0.2, 0.2, 0.2]
    sph = pik.pack_sphere_table(torch.tensor(centers), torch.tensor(radii))
    quad = torch.zeros(0, 12)
    eye = [13.0, 2.0, 3.0]
    o, d, c, r = grazing_rays(centers[1:], radii[1:], eye, inset=0.01)
    t0, p0 = pik.intersect(sph, quad, o, d)
    t1, p1 = pik.intersect(sph, quad, o, d, torch.tensor(radii))
    assert torch.equal(p0, p1) and bool((p0 >= 1).all())

    def off(t):
        p = o.double() + t.double()[:, None] * d.double()
        return ((p - c).norm(dim=1) - r).abs()

    assert float(off(t1).max()) < 1e-5, float(off(t1).max())
    assert float(off(t0).max()) > 1e-4, float(off(t0).max())
    go, gd = torch.tensor([eye] * 3), torch.tensor([[-1.0, -0.1, 0.0], [0.0, -0.2, -1.0],
                                                   [-1.0, -0.3, -1.0]])
    tg0, pg0 = pik.intersect(sph, quad, go, gd)
    tg1, pg1 = pik.intersect(sph, quad, go, gd, torch.tensor(radii))
    assert pg0.tolist() == [0, 0, 0] and torch.equal(pg0, pg1) and torch.equal(tg0, tg1)
