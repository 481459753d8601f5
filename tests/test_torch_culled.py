"""The large-scene path against the JAX package: the NumPy BVH builder and
the cluster tables (array-equal), kernel 4's plain twin
(ops/culled_kernel.py:intersect_culled_plain) against JAX
intersect_pallas_culled in interpret mode and against the port's dense
search, and the large-scene render against the JAX package's CPU render."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.geometry import bvh as jbvh
from raytracer_tpu.geometry.intersect import quad_derived
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.ops import culled_kernel as jck
from raytracer_tpu.ops import intersect_kernel as jik
from raytracer_tpu.render.driver import render_image as jax_render_image
from raytracer_tpu.scenes import builders as jbuilders
from raytracer_tpu_torch.geometry import bvh as pbvh
from raytracer_tpu_torch.geometry import intersect as pint
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.ops import culled_kernel as pck
from raytracer_tpu_torch.ops import intersect_kernel as pik
from raytracer_tpu_torch.render import driver as pdriver
from raytracer_tpu_torch.scenes import builders as pbuilders

torch.set_num_threads(1)


def port(jsc):
    return pscene.scene_from_arrays(
        {k: np.asarray(getattr(jsc, k)) for k in pscene.TENSOR_FIELDS},
        {k: getattr(jsc, k) for k in pscene.FLAG_FIELDS},
    )


def sphere_field(builder_cls, rng_seed=1234, quad=True):
    """tests/test_culled_kernel.py's scene: 60 spheres and a big quad."""
    rng = np.random.default_rng(rng_seed)
    b = builder_cls(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(60):
        b.add_sphere(rng.uniform(-6, 6, 3), rng.uniform(0.2, 0.8), m)
    if quad:
        b.add_quad((-8, -8, -7), (16, 0, 0), (0, 16, 0), m)
    return b.build()


def plane_scene(builder_cls):
    """tests/test_culled_kernel.py's second scene: a ray on a cluster plane."""
    b = builder_cls(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -5.0), 1.0, m)
    b.add_sphere((3.0, 0.0, -5.0), 0.5, m)
    b.add_sphere((-3.0, 0.0, -5.0), 0.5, m)
    return b.build()


SCENES = {
    "sphere_field": lambda: sphere_field(SceneBuilder),
    "large_1000": lambda: jbuilders.rand_spheres_large(width=32, spp=2, n_spheres=1000)[0],
    "quad_field_300": lambda: jbuilders.quad_field(width=32, n_spheres=300)[0],
    "plane": lambda: plane_scene(SceneBuilder),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_and_clusters_equal_jax(name):
    """build_bvh (NumPy, leaf 8) and build_clusters (leaf 8 and 128) are
    array-equal to the JAX package's on the same scene."""
    jsc = SCENES[name]()
    psc = port(jsc)
    jb = jbvh.build_bvh(jsc, leaf_size=8, use_native=False)
    pb = pbvh.build_bvh(psc, leaf_size=8)
    for f in pbvh.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(pb, f), np.asarray(getattr(jb, f)), err_msg=f)
    for lo, hi in zip(pbvh.primitive_bounds(psc), jbvh.primitive_bounds(jsc)):
        np.testing.assert_array_equal(lo, hi)
    for max_leaf in (8, 128):
        got = pck.build_clusters(psc, max_leaf=max_leaf)
        want = jck.build_clusters(jsc, max_leaf=max_leaf)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cluster_rows_equal_dense_rows():
    """Every cluster-ordered sphere row is bit-equal to the dense table's
    row of its global id, so the culled search's candidates are kernel 1's."""
    psc = port(SCENES["large_1000"]())
    tables = pint.build_large_scene_tables(psc)
    assert tables.clusters.shape[0] >= 8
    dense = tables.sph_table[tables.orig_ids.long()]
    assert torch.equal(tables.sph_clustered, dense)
    assert sorted(tables.orig_ids.tolist()) == list(range(psc.num_spheres))


def random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = (rng.uniform(-4, 4, (n, 3)).astype(np.float32) - o).astype(np.float32)
    return o, d


def jax_culled(jsc, max_leaf, o, d, monkeypatch, rows):
    import jax.experimental.pallas as pl

    cl, order, sph_cl, orig = jck.build_clusters(jsc, max_leaf=max_leaf)
    qt = jik.pack_quad_table(quad_derived(jsc))
    orig_call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))
    t, p = jck.intersect_pallas_culled(cl, order, sph_cl, orig, qt, jsc.num_spheres,
                                       jnp.asarray(o), jnp.asarray(d), rows=rows)
    return np.asarray(t), np.asarray(p)


def port_culled(psc, max_leaf, o, d, **kw):
    cl, order, sph_cl, orig = pck.build_clusters(psc, max_leaf=max_leaf)
    qt = pik.pack_quad_table(pint.quad_derived(psc))
    return pck.intersect_culled_plain(cl, order, sph_cl, orig, qt, psc.num_spheres,
                                      torch.from_numpy(o), torch.from_numpy(d), **kw)


def test_culled_twin_matches_jax_interpret(monkeypatch):
    """tests/test_culled_kernel.py's scene and rays: the twin against the
    JAX kernel in interpret mode, hit or miss equal, t within that test's
    rtol 2e-4 / atol 1e-5 (measured 5e-5: the interpreter rounds the
    expanded sphere formula otherwise, and the JAX kernel differs from the
    JAX dense search by as much, ROADMAP Queue 3), prim equal on >= 99.9%
    of rays."""
    jsc = sphere_field(SceneBuilder)
    o, d = random_rays(8 * 128, 3)
    t_j, p_j = jax_culled(jsc, 8, o, d, monkeypatch, rows=8)
    t_p, p_p = port_culled(port(jsc), 8, o, d)
    t_p, p_p = t_p.numpy(), p_p.numpy()
    np.testing.assert_array_equal(np.isfinite(t_p), np.isfinite(t_j))
    hit = np.isfinite(t_j)
    assert hit.sum() > 300
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=2e-4, atol=1e-5)
    assert (p_p == p_j).mean() >= 0.999


def test_culled_twin_ray_on_cluster_plane(monkeypatch):
    """The JAX test's degenerate rays (zero x and y direction, origin on a
    cluster's min-x plane): the twin hits as the JAX kernel does, and its
    slab test enters the cluster (the +-1e-30 nudge keeps it conservative)."""
    jsc = plane_scene(SceneBuilder)
    psc = port(jsc)
    bmin_x = float(pck.build_clusters(psc, max_leaf=2)[0][:, 0].min())
    o = np.tile(np.float32([[bmin_x, 0.0, 0.0]]), (128, 1))
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (128, 1))
    t_j, p_j = jax_culled(jsc, 2, o, d, monkeypatch, rows=1)
    t_p, p_p, work = port_culled(psc, 2, o, d, return_work=True)
    assert np.isfinite(t_p.numpy()).all() and (work > 0).all()
    np.testing.assert_allclose(t_p.numpy(), t_j, rtol=1e-6)
    np.testing.assert_array_equal(p_p.numpy(), p_j)


@pytest.mark.parametrize("name", ["sphere_field", "large_1000"])
def test_culled_twin_equals_dense_search(name):
    """Against the port's dense intersect_plain on the same rays: t equal
    on every ray, prim equal except where two primitives give the same
    scaled t exactly (counted: none here). Culled work (with perfect
    per-ray culling) is below the dense work."""
    psc = port(SCENES[name]())
    if name == "large_1000":
        _, cam, st = pbuilders.rand_spheres_large(width=48, n_spheres=1000)
        from raytracer_tpu_torch.core.camera import camera_frame, camera_rays
        from raytracer_tpu_torch.ops import ctr_rng

        n = st.width * st.height
        sid = torch.arange(2 * n)
        pix = sid % n
        o, d = camera_rays(camera_frame(cam, st.width, st.height), pix % st.width,
                           pix // st.width, ctr_rng.camera_uniforms(4, sid))
        o, d = o.contiguous().numpy(), d.numpy()
    else:
        o, d = random_rays(4096, 5)
    t_c, p_c, work = port_culled(psc, 128 if name == "large_1000" else 8, o, d, return_work=True)
    sph, quad = pint.scene_tables(psc)
    t_d, p_d = pik.intersect_plain(sph, quad, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(t_c, t_d)
    assert int((p_c != p_d).sum()) == 0
    assert float(work.float().mean()) < psc.num_spheres


def large_scene(scene, cam, settings, **kw):
    """The large-scene path on one CPU device, on any scene."""
    return pdriver.render_loop(scene, cam, settings, path="large_scene", device="cpu", **kw)


def test_large_scene_render_matches_jax():
    """rand_spheres_large with 1,000 spheres at 32x18, 2 spp, depth 8,
    through the large-scene path (kernel 4's and kernel 1's twins), against
    the JAX package's CPU render of the same scene: the channel means of
    four seeds each agree within 4% (measured spread of a seed's mean:
    about 1%), and every pixel is finite."""
    jsc, jcam, jst = jbuilders.rand_spheres_large(width=32, spp=2, n_spheres=1000)
    psc, pcam, pst = pbuilders.rand_spheres_large(width=32, spp=2, n_spheres=1000)
    want = np.mean([np.asarray(jax_render_image(jsc, jcam, jst, seed=s)) for s in range(4)], axis=0)
    got = np.mean([large_scene(psc, pcam, pst, seed=s).numpy()
                   for s in range(4)], axis=0)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.04)


def test_large_scene_path_counts_passes(monkeypatch):
    """spp 6 at 16x9 with a pass budget of 3 samples per pixel: two passes,
    every camera ray traced (segments >= pixels x spp)."""
    from raytracer_tpu_torch.utils.metrics import RenderMetrics

    psc, cam, st = pbuilders.rand_spheres_large(width=16, spp=6, n_spheres=300)
    assert pdriver.samples_per_pass_for(6, 144, 3 * 144) == 3
    monkeypatch.setattr(pdriver, "TARGET_RAYS_PER_PASS", 3 * 144)
    metrics = RenderMetrics(total_spp=6, pixels=144)
    img = large_scene(psc, cam, st, seed=1, metrics=metrics)
    assert bool(torch.isfinite(img).all()) and img.shape == (9, 16, 3)
    assert metrics.passes == 2 and metrics.traced_segments >= 144 * 6
    assert metrics.iterations >= 2


def large_scene_launches(monkeypatch, width=48, spp=2, n_spheres=1000, seed=2):
    """The large-scene path on rand_spheres_large (CPU, one pass): the scene
    it renders, its (ClusterTable, sphere, quad tables), and the rays of its
    kernel-4 launch and of each clustered kernel-1 launch, recorded as the
    path makes them. Also every dense kernel-1 call it makes."""
    psc, cam, st = pbuilders.rand_spheres_large(width=width, spp=spp, n_spheres=n_spheres)
    calls = {"culled": [], "clustered": [], "dense": []}

    def recorder(kind, real):
        def call(*args):
            calls[kind].append(args)
            return real(*args)
        return call

    monkeypatch.setattr(pck, "intersect_culled", recorder("culled", pck.intersect_culled))
    monkeypatch.setattr(pik, "intersect_clustered",
                        recorder("clustered", pik.intersect_clustered))
    monkeypatch.setattr(pik, "intersect", recorder("dense", pik.intersect))
    monkeypatch.setattr(pdriver, "TARGET_RAYS_PER_PASS", spp * st.width * st.height)
    large_scene(psc, cam, st, seed=seed)
    return psc, cam, calls


def test_clustered_twin_equals_dense_search_on_bounce_rays(monkeypatch):
    """Kernel 1's clustered entry's twin (ClusterVisit.hit) on every bounce
    launch of a large-scene pass over rand_spheres_large (1,000 spheres):
    origins on surfaces, where the expanded-form sphere test re-hits its
    own surface just past T_MIN. Against intersect_plain on the same
    permuted tables, t equal on every ray and prim equal but for exact ties
    (counted: none here); the culled walk at the kernel's slab pad
    (utils/cull_divergence.py's model) changes no winner."""
    from raytracer_tpu_torch.ops import cluster_visit as pcv
    from raytracer_tpu_torch.ops import persistent_kernel as ppk
    from raytracer_tpu_torch.utils.cull_divergence import divergent_rays

    _, _, calls = large_scene_launches(monkeypatch)
    assert len(calls["clustered"]) >= 3 and not calls["dense"]
    clusters, sph, quad = calls["clustered"][0][:3]
    assert clusters.n_sph >= 8
    visit = pcv.ClusterVisit.build(clusters, sph, quad)
    ties = rays = 0
    for _, _, _, o, d in calls["clustered"]:
        t_c, p_c = visit.hit(o, d)
        t_d, p_d = pik.intersect_plain(sph, quad, o, d)
        assert torch.equal(t_c, t_d)
        assert int(((p_c != p_d) & (t_c == t_d)).sum()) == int((p_c != p_d).sum())
        ties += int((p_c != p_d).sum())
        rays += o.shape[0]
        assert divergent_rays(visit, o, d, (ppk.CLUSTER_SLAB_PAD,)) == {ppk.CLUSTER_SLAB_PAD: 0}
    assert rays > 2000 and ties == 0


def test_cluster_visit_equals_the_tpu_kernels_search_on_camera_rays(monkeypatch):
    """Kernel 4's twin on the render's two-level table (ClusterVisit.hit)
    against the TPU kernel's flat-table search (intersect_culled_plain) on
    the large-scene path's own camera rays: t equal on every ray, prim
    (mapped back to the unpermuted scene) equal but for exact ties
    (counted: none here)."""
    from raytracer_tpu_torch.ops import cluster_visit as pcv

    psc, _, calls = large_scene_launches(monkeypatch)
    clusters, sph, quad, o, d = calls["culled"][0]
    t_v, p_v = pcv.ClusterVisit.build(clusters, sph, quad).hit(o, d)
    order = pdriver._cluster_order_cached(psc)
    ns = psc.num_spheres
    quad_order = order.quad if order.quad is not None else torch.arange(psc.num_quads)
    back = torch.cat([order.sph.long(), ns + quad_order.long()])
    p_v = torch.where(p_v >= 0, back[p_v.clamp(min=0).long()], -1).to(torch.int32)
    cl, cl_order, sph_cl, orig = pck.build_clusters(psc)
    qt = pik.pack_quad_table(pint.quad_derived(psc))
    t_f, p_f = pck.intersect_culled_plain(cl, cl_order, sph_cl, orig, qt, ns, o, d)
    assert torch.equal(t_v, t_f)
    ties = int((p_v != p_f).sum())
    assert int(((p_v != p_f) & (t_v == t_f)).sum()) == ties == 0
    assert float((p_v >= 0).float().mean()) > 0.5


def test_large_scene_path_culls_every_search_and_launches_nothing_on_cpu(monkeypatch):
    """The large-scene path on CPU tensors: camera rays through kernel 4's
    wrapper, every bounce through kernel 1's clustered entry, no dense
    kernel-1 call, all on one two-level cluster table of the permuted scene,
    and no wrapper counts a launch."""
    before = (pik.LAUNCHES, pik.LAUNCHES_CLUSTERED, pck.LAUNCHES)
    psc, _, calls = large_scene_launches(monkeypatch, width=16, spp=2, n_spheres=300)
    assert len(calls["culled"]) == 1 and len(calls["clustered"]) >= 2 and not calls["dense"]
    tables = calls["culled"][0][:3]
    assert all(c[0] is tables[0] and c[1] is tables[1] for c in calls["clustered"])
    assert tables[0].n_sph > 0 and tables[1].shape[0] == psc.num_spheres
    assert (pik.LAUNCHES, pik.LAUNCHES_CLUSTERED, pck.LAUNCHES) == before
