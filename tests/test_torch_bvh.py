"""The port's stackless BVH traversal (geometry/bvh.py:bvh_closest_hit) against
the JAX package's on tests/test_bvh.py's cases (random scenes and the
reference scene): t within 1e-5 relative and prim ids equal, the same BVH
arrays (the builders are byte-identical), and against the port's dense
closest hit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.geometry.bvh import build_bvh as jax_build_bvh
from raytracer_tpu.geometry.bvh import bvh_closest_hit as jax_bvh_closest_hit
from raytracer_tpu.geometry.scene import SceneBuilder as JaxSceneBuilder
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.geometry.bvh import build_bvh, bvh_closest_hit
from raytracer_tpu_torch.geometry.intersect import closest_hit_t_prim

torch.set_num_threads(1)


def port_scene(jax_scene):
    return pscene.scene_from_arrays(
        {k: np.asarray(getattr(jax_scene, k)) for k in pscene.TENSOR_FIELDS},
        {k: getattr(jax_scene, k) for k in pscene.FLAG_FIELDS},
    )


def random_scene(seed, n_spheres=40, n_quads=10):
    """tests/test_bvh.py:_random_scene."""
    rng = np.random.default_rng(seed)
    b = JaxSceneBuilder(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-6, 6, 3), rng.uniform(0.2, 1.2), m)
    for _ in range(n_quads):
        b.add_quad(rng.uniform(-6, 6, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), m)
    return b.build()


def random_rays(seed, n=512):
    """tests/test_bvh.py:test_traversal_matches_dense's rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = (rng.uniform(-5, 5, (n, 3)).astype(np.float32) - o).astype(np.float32)
    return o, d


def cornell_case():
    """tests/test_bvh.py:test_traversal_on_reference_scene: rays from the
    camera to random points inside the box, every one a hit."""
    scene, _, _ = jax_get_scene("cornell", width=32, spp=1)
    rng = np.random.default_rng(0)
    n = 256
    o = np.tile(np.array([[278, 278, -800]], np.float32), (n, 1))
    target = rng.uniform([0, 0, 0], [555, 555, 555], (n, 3)).astype(np.float32)
    return scene, o, target - o


def both(jscene, o, d):
    """(JAX t, JAX prim, port t, port prim), the port on its own BVH."""
    jt, jp = jax_bvh_closest_hit(jscene, jax_build_bvh(jscene), jnp.asarray(o), jnp.asarray(d))
    scene = port_scene(jscene)
    t, p = bvh_closest_hit(scene, build_bvh(scene), torch.from_numpy(o), torch.from_numpy(d))
    return np.asarray(jt), np.asarray(jp), t, p


def hold_against_jax(jt, jp, t, p):
    t, p = t.numpy(), p.numpy()
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(jt))
    hit = np.isfinite(jt)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(p, np.where(hit, jp, -1))


@pytest.mark.parametrize("seed", [1234, 7, 99])
def test_traversal_matches_jax_on_random_scenes(seed):
    jscene = random_scene(seed)
    o, d = random_rays(seed + 1)
    jt, jp, t, p = both(jscene, o, d)
    assert t.dtype == torch.float32 and p.dtype == torch.int32 and t.shape == (512,)
    assert np.isfinite(jt).sum() > 150
    hold_against_jax(jt, jp, t, p)


def test_traversal_matches_jax_on_reference_scene():
    jscene, o, d = cornell_case()
    jt, jp, t, p = both(jscene, o, d)
    assert np.isfinite(jt).all()
    hold_against_jax(jt, jp, t, p)


def test_same_tree_as_jax():
    jscene = random_scene(5)
    jb, pb = jax_build_bvh(jscene), build_bvh(port_scene(jscene))
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["random", "cornell"])
def test_traversal_matches_the_dense_closest_hit(case):
    """Against the port's dense search (ops/intersect_kernel.py:
    intersect_plain, the kernel's twin): the same hits at test_bvh.py's
    tolerances (the dense search compares in a scaled-t space, so ties and
    grazing rays may differ in the last bits); on the reference scene every
    prim id equal."""
    if case == "random":
        jscene = random_scene(1234)
        o, d = random_rays(4321)
    else:
        jscene, o, d = cornell_case()
    scene = port_scene(jscene)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t, p = bvh_closest_hit(scene, build_bvh(scene), o, d)
    tr, pr = closest_hit_t_prim(scene, o, d)
    hit = torch.isfinite(tr)
    assert (torch.isfinite(t) == hit).float().mean() > 0.995
    both_hit = torch.isfinite(t) & hit
    close = torch.isclose(t[both_hit], tr[both_hit], rtol=2e-4, atol=1e-5)
    assert close.float().mean() > 0.995
    if case == "cornell":
        assert bool(hit.all())
        torch.testing.assert_close(t, tr, rtol=2e-4, atol=1e-4)
        assert torch.equal(p, pr)


def test_miss_everything_and_empty_batch():
    jscene = random_scene(3)
    scene = port_scene(jscene)
    bvh = build_bvh(scene)
    o = torch.tensor([[0.0, 100.0, 0.0]] * 4)
    d = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 1.0]])
    t, p = bvh_closest_hit(scene, bvh, o, d)
    assert torch.isinf(t).all() and (p == -1).all()
    t, p = bvh_closest_hit(scene, bvh, o[:0], d[:0])
    assert t.shape == (0,) and p.shape == (0,)
