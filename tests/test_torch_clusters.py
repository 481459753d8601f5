"""Kernel 2's cluster culling on the CPU: the C++ BVH builder, cluster_scene,
the driver's front-to-back order and cluster_for_render against the JAX
package's (array-equal), and the clustered plain twin
(integrator/wavefront.py:regen_plain with a ClusterTable) against the dense
twin bit for bit on the scenes of tests/test_persistent_kernel.py:339-488,
against an independent culling walk, and against JAX `trace`."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.geometry import bvh as jbvh
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.integrator import wavefront as jwf
from raytracer_tpu.ops import ctr_rng as jrng
from raytracer_tpu.render import driver as jdriver
from raytracer_tpu.scenes import builders as jbuilders
from raytracer_tpu_torch import native
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.geometry import bvh as pbvh
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.integrator import wavefront as pwf
from raytracer_tpu_torch.ops import cluster_visit as pcv
from raytracer_tpu_torch.ops import culled_kernel as pck
from raytracer_tpu_torch.ops import intersect_kernel as pik
from raytracer_tpu_torch.ops import persistent_kernel as ppk
from raytracer_tpu_torch.render import driver as pdriver
from raytracer_tpu_torch.scenes import builders as pbuilders
from raytracer_tpu_torch.utils.metrics import RenderMetrics

from cluster_scenes import SCENES, TWIN_CASES, grid_6x6

torch.set_num_threads(1)


def port(jsc):
    return pscene.scene_from_arrays(
        {k: np.asarray(getattr(jsc, k)) for k in pscene.TENSOR_FIELDS},
        {k: getattr(jsc, k) for k in pscene.FLAG_FIELDS},
    )


def port_scene(name, width=24):
    scene, kw = SCENES[name](pscene.SceneBuilder(0))
    cam, st = pcam.make_camera(1.0, width, **kw)
    return scene, cam, st


def twin(scene, cam, st, clusters=None, *, spp=None, wavefront=1024, rr_start=5, seed=3,
         return_work=False):
    """render_persistent on CPU tables (regen_plain), dense or clustered;
    with `return_work`, regen_plain itself, which also counts the culled
    loops' work."""
    w, h = st.width, st.height
    spp = spp or st.samples_per_pixel
    n, num_slots, jump = pwf.strided_schedule(w * h, spp, wavefront)
    rem0, px0, py0 = pwf.schedule_arrays(n, w * h, spp, w)
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, w, h), cam.background)
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.materials.packed import texture_tables

    cfg = dict(width=w, height=h, jump_px=jump % w, jump_py=jump // w, num_slots=num_slots,
               max_depth=st.max_depth, rr_start=rr_start, sky_gradient=st.sky_gradient,
               textures=texture_tables(scene, quad_derived(scene)), clusters=clusters)
    args = (sph, quad, res, cam_s, seed, rem0, px0, py0)
    if return_work:
        return pwf.regen_plain(*args, **cfg, rr_lo=0.05, rr_hi=0.75, return_work=True,
                               max_iters=ppk.max_iters_for(num_slots, st.max_depth))
    return ppk.render_persistent(*args, **cfg)


# ---- the C++ BVH builder and the host clustering, against JAX ----

LARGE = {"rand_spheres_large": lambda m: m.rand_spheres_large(width=32),
         "quad_field": lambda m: m.quad_field(width=32)}


@pytest.mark.parametrize("name", sorted(LARGE))
def test_native_builder_equals_numpy_and_jax(name):
    """The port's C++ builder (compiled here with g++) against its NumPy
    builder and the JAX package's build_bvh: every array equal."""
    assert native.available(), native.build_error()
    jsc = LARGE[name](jbuilders)[0]
    psc = port(jsc)
    got, builder = pbvh.build_bvh_reporting(psc, leaf_size=8)
    assert builder == "native"
    numpy_tree, numpy_builder = pbvh.build_bvh_reporting(psc, leaf_size=8, use_native=False)
    assert numpy_builder == "numpy"
    want = jbvh.build_bvh(jsc, leaf_size=8, use_native=False)
    for f in pbvh.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(numpy_tree, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


CLUSTER_CASES = [
    ("rand_spheres_large", dict(max_leaf=64, super_fan=16)),
    ("quad_field", dict(max_leaf=64, super_fan=16)),
    ("grid_two_level", dict(max_leaf=4, super_fan=4, min_fine_for_super=8)),
    ("grid_6x6", dict(max_leaf=8)),
    ("image_quad_field", dict(max_leaf=4, super_fan=2, min_fine_for_super=2)),
]


def both_scenes(name):
    """(JAX scene, port scene, JAX camera, port camera) of the same
    construction."""
    if name in LARGE:
        jsc, jc, _ = LARGE[name](jbuilders)
        return jsc, port(jsc), jc, LARGE[name](pbuilders)[1]
    jsc, kw = SCENES[name](jscene.SceneBuilder(0))
    return (jsc, SCENES[name](pscene.SceneBuilder(0))[0], jcam.make_camera(1.0, 24, **kw)[0],
            pcam.make_camera(1.0, 24, **kw)[0])


@pytest.mark.parametrize("name,kw", CLUSTER_CASES)
def test_cluster_scene_equals_jax(name, kw):
    """The permuted scene (every field) and the four row tables are
    array-equal to JAX cluster_scene's."""
    jsc, psc, _, _ = both_scenes(name)
    jscl, jcs = jbvh.cluster_scene(jsc, **kw)
    pscl, pcs = pbvh.cluster_scene(psc, **kw)
    assert pcs.builder == "native"
    for f in ("sph", "sph_super", "quad", "quad_super"):
        np.testing.assert_array_equal(getattr(pcs, f), np.asarray(getattr(jcs, f)), err_msg=f)
    for f in pscene.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(pscl, f).numpy(), np.asarray(getattr(jscl, f)),
                                      err_msg=f)
    assert pscl.num_prims <= psc.num_prims


def jax_granularity(monkeypatch):
    """The port's render driver set to cluster as the JAX one: its leaf and
    fan for both kinds, and no oversized primitive isolated."""
    grain = (jdriver.CLUSTER_LEAF, jdriver.CLUSTER_FAN)
    monkeypatch.setattr(pdriver, "CLUSTER_GRAIN", {"sph": grain, "quad": grain})
    monkeypatch.setattr(pdriver, "CLUSTER_OVERSIZE", math.inf)


@pytest.mark.parametrize("name,kw", CLUSTER_CASES)
def test_front_to_back_and_cluster_for_render_equal_jax(name, kw, monkeypatch):
    """_order_front_to_back on the case's tables, and cluster_for_render at
    the JAX driver's granularity (the port's own constants and its
    oversized-primitive split are held by the tests further down), are
    array-equal to the JAX driver's; a super level still tiles the fine
    rows."""
    jax_granularity(monkeypatch)
    jsc, psc, jc, pc = both_scenes(name)
    _, jcs = jbvh.cluster_scene(jsc, **kw)
    _, pcs = pbvh.cluster_scene(psc, **kw)
    eye = np.asarray(jc.look_from)
    for kind in ("sph", "quad"):
        want = jdriver._order_front_to_back(np.asarray(getattr(jcs, kind)),
                                            np.asarray(getattr(jcs, kind + "_super")), eye)
        got = pdriver._order_front_to_back(getattr(pcs, kind), getattr(pcs, kind + "_super"), eye)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        fine, sup = got
        if sup.shape[0]:
            np.testing.assert_array_equal(sup[:, 6], np.concatenate([[0], np.cumsum(sup[:-1, 7])]))
            assert int(sup[:, 7].sum()) == fine.shape[0]
    np.testing.assert_array_equal(pc.look_from.numpy(), eye)
    jscl, jset = jdriver.cluster_for_render(jsc, jc)
    pscl, pset = pdriver.cluster_for_render(psc, pc)
    for f in ("sph", "sph_super", "quad", "quad_super"):
        np.testing.assert_array_equal(getattr(pset, f), np.asarray(getattr(jset, f)), err_msg=f)
    for f in pscene.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(pscl, f).numpy(), np.asarray(getattr(jscl, f)),
                                      err_msg=f)


# The large scenes of the persistent path, host-clustered at the render driver's
# granularity (no render), and the kind that holds their ground primitive.
SPLIT_CASES = [("rand_spheres_large", {}, "sph"), ("quad_field", {}, "quad"),
               ("rand_spheres_large", {"n_spheres": 50000}, "sph")]


def driver_order(scene):
    """cluster_order at the render driver's granularity, before and after
    isolate_oversized."""
    (leaf, fan), quad_grain = pdriver.CLUSTER_GRAIN["sph"], pdriver.CLUSTER_GRAIN["quad"]
    order = pbvh.cluster_order(scene, max_leaf=leaf, super_fan=fan, quad_grain=quad_grain)
    return order, pbvh.isolate_oversized(scene, order, pdriver.CLUSTER_OVERSIZE)


def kind_rows(order, kind):
    """(permutation (numpy), fine rows, super rows) of one kind."""
    perm = order.sph if kind == "sph" else order.quad
    return perm.numpy(), getattr(order.clusters, kind), getattr(order.clusters, kind + "_super")


@pytest.mark.parametrize("name,kw,kind", SPLIT_CASES)
def test_isolated_rows_cover_every_primitive_once_and_bound_it(name, kw, kind):
    """After isolate_oversized the fine rows tile the kind's permuted table
    and the supers tile the fine rows, each exactly once and in order; the
    permutation holds the same primitives as cluster_order's; every fine
    box equals the hull of its primitives' boxes and every super box the
    hull of its fine rows."""
    scene, _, _ = getattr(pbuilders, name)(width=32, **kw)
    before, after = driver_order(scene)
    perm0, _, _ = kind_rows(before, kind)
    perm, fine, sup = kind_rows(after, kind)
    assert sorted(perm.tolist()) == sorted(perm0.tolist())
    np.testing.assert_array_equal(fine[:, 6], np.concatenate([[0], np.cumsum(fine[:-1, 7])]))
    assert int(fine[:, 7].sum()) == len(perm) and (fine[:, 7] > 0).all()
    np.testing.assert_array_equal(sup[:, 6], np.concatenate([[0], np.cumsum(sup[:-1, 7])]))
    assert int(sup[:, 7].sum()) == len(fine) and (sup[:, 7] > 0).all()
    bmin, bmax = pbvh.primitive_bounds(scene)
    gid = perm + (scene.num_spheres if kind == "quad" else 0)
    for row in fine:
        ids = gid[int(row[6]) : int(row[6] + row[7])]
        np.testing.assert_array_equal(row[:3], bmin[ids].min(axis=0))
        np.testing.assert_array_equal(row[3:6], bmax[ids].max(axis=0))
    for row in sup:
        block = fine[int(row[6]) : int(row[6] + row[7])]
        np.testing.assert_array_equal(row[:3], block[:, :3].min(axis=0))
        np.testing.assert_array_equal(row[3:6], block[:, 3:6].max(axis=0))


@pytest.mark.parametrize("name,kw,kind", SPLIT_CASES)
def test_isolate_oversized_moves_exactly_the_ground(name, kw, kind):
    """Each large scene's one oversized primitive is its 2000-wide ground
    (row 0 of its kind): it ends the permuted table, in a fine row of its
    own (the last) under a super of its own (the last); every other row
    keeps its primitives, and no other row is a quarter as wide."""
    scene, _, _ = getattr(pbuilders, name)(width=32, **kw)
    before, after = driver_order(scene)
    perm0, fine0, sup0 = kind_rows(before, kind)
    perm, fine, sup = kind_rows(after, kind)
    assert perm[-1] == 0 and len(perm) == len(perm0)
    assert fine[-1, 6:].tolist() == [len(perm) - 1, 1]
    assert sup[-1, 6:].tolist() == [len(fine) - 1, 1]
    assert (fine[-1, 3:6] - fine[-1, :3]).max() == 2000
    assert len(fine) == len(fine0) + 1 and len(sup) == len(sup0) + 1
    width = lambda rows: (rows[:, 3:6] - rows[:, :3]).max(axis=1)  # noqa: E731
    assert width(fine0).max() >= 2000 and width(sup0).max() >= 2000
    assert width(fine[:-1]).max() < 500 and width(sup[:-1]).max() < 500
    ground = int(np.flatnonzero(perm0 == 0)[0])
    np.testing.assert_array_equal(np.delete(perm0, ground), perm[:-1])


@pytest.mark.parametrize("name,kw", [case[:2] for case in TWIN_CASES[1:]])
def test_isolate_oversized_leaves_other_scenes_unchanged(name, kw):
    """A scene with no oversized primitive (the JAX culling scenes with a
    super level, and grid_6x6's single ground quad, which has none) keeps
    its ClusterOrder array for array."""
    scene, _, _ = port_scene(name)
    order = pbvh.cluster_order(scene, **kw)
    got = pbvh.isolate_oversized(scene, order)
    assert torch.equal(got.sph, order.sph) and torch.equal(got.quad, order.quad)
    for f in ("sph", "sph_super", "quad", "quad_super"):
        np.testing.assert_array_equal(getattr(got.clusters, f), getattr(order.clusters, f))


def counting_cluster_order(monkeypatch):
    """The number of host clusterings render/driver.py runs, as a one-entry
    list."""
    calls = [0]
    real = pdriver.cluster_order

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(pdriver, "cluster_order", counted)
    pdriver._CLUSTER_CACHE.clear()
    return calls


def test_cluster_for_render_caches_per_scene(monkeypatch):
    """A second render of the same scene object reuses its clustering (one
    host clustering, the same permuted tables); a scene of new tensors is
    clustered anew, to the same rows."""
    calls = counting_cluster_order(monkeypatch)
    psc, cam, _ = pbuilders.rand_spheres_large(width=8, n_spheres=2000)
    first = pdriver.cluster_for_render(psc, cam)
    again = pdriver.cluster_for_render(psc, cam)
    assert calls[0] == 1
    for f in pscene.TENSOR_FIELDS:
        assert torch.equal(getattr(again[0], f), getattr(first[0], f)), f
    other = pdriver.cluster_for_render(pbuilders.rand_spheres_large(width=8, n_spheres=2000)[0],
                                       cam)
    assert calls[0] == 2
    np.testing.assert_array_equal(other[1].sph, first[1].sph)


def cache_scene():
    """rand_spheres_large cut to 2,000 spheres (past CLUSTERED_SCENE_PRIMS),
    8 px wide, 2 spp, depth 3."""
    scene, cam, st = pbuilders.rand_spheres_large(width=8, spp=2, max_depth=3, n_spheres=2000)
    assert scene.num_prims > ppk.CLUSTERED_SCENE_PRIMS
    return scene, cam, st


def render_and_cluster(scene, cam, st):
    """(cluster_for_render's permuted scene and ClusterSet, render_image's
    image) on the CPU."""
    return (pdriver.cluster_for_render(scene, cam),
            pdriver.render_image(scene, cam, st, device="cpu", seed=4))


def assert_same_clustered_render(got, want):
    (g_scene, g_cs), g_img = got
    (w_scene, w_cs), w_img = want
    for f in pscene.TENSOR_FIELDS:
        assert torch.equal(getattr(g_scene, f), getattr(w_scene, f)), f
    for f in ("sph", "sph_super", "quad", "quad_super"):
        np.testing.assert_array_equal(getattr(g_cs, f), getattr(w_cs, f), err_msg=f)
    assert torch.equal(g_img, w_img)


def test_cluster_cache_follows_an_in_place_geometry_update():
    """Sphere centers moved in place (as torch.optim moves trainable leaves)
    between two renders: the second render equals one with a cleared cache
    bit for bit, and differs from the first."""
    scene, cam, st = cache_scene()
    pdriver._CLUSTER_CACHE.clear()
    pdriver.clear_pack_cache()
    before = render_and_cluster(scene, cam, st)
    with torch.no_grad():
        scene.sph_center[:, 0] += 5
    got = render_and_cluster(scene, cam, st)
    pdriver._CLUSTER_CACHE.clear()
    pdriver.clear_pack_cache()
    assert_same_clustered_render(got, render_and_cluster(scene, cam, st))
    assert not torch.equal(got[1], before[1])


def test_cluster_cache_follows_a_replaced_scene():
    """dataclasses.replace keeping the geometry tensors but zeroing the
    texture colors and albedos (as diff/grad.py:split_scene's rebuild
    replaces leaves): the render equals one with a cleared cache bit for
    bit, and differs from the first scene's."""
    scene, cam, st = cache_scene()
    pdriver._CLUSTER_CACHE.clear()
    pdriver.clear_pack_cache()
    before = render_and_cluster(scene, cam, st)
    dark = dataclasses.replace(scene, tex_c0=torch.zeros_like(scene.tex_c0),
                               tex_c1=torch.zeros_like(scene.tex_c1),
                               mat_albedo=torch.zeros_like(scene.mat_albedo))
    assert dark.sph_center is scene.sph_center
    got = render_and_cluster(dark, cam, st)
    pdriver._CLUSTER_CACHE.clear()
    pdriver.clear_pack_cache()
    assert_same_clustered_render(got, render_and_cluster(dark, cam, st))
    assert not torch.equal(got[1], before[1])


# ---- the clustered twin ----


def small_large_scene(name, width=16, spp=2):
    """rand_spheres_large or quad_field cut to 3,000 primitives (at least
    three supers at the render driver's granularity), `width` wide, depth 8."""
    return getattr(pbuilders, name)(width=width, spp=spp, n_spheres=3000)


# TWIN_CASES, and the large scenes cut to size with the render driver's own
# clustering (cluster_for_render: its granularity, the ground isolated).
CLUSTERED_TWIN_CASES = TWIN_CASES + [("rand_spheres_large", None, True),
                                     ("quad_field", None, True)]


@pytest.mark.parametrize("name,kw,front_to_back", CLUSTERED_TWIN_CASES)
def test_clustered_twin_equals_dense_twin(name, kw, front_to_back):
    """tests/test_persistent_kernel.py:339-488 for the port: the twin with
    the cluster table on the permuted scene equals the dense twin on the
    original scene bit for bit (log and segments), with and without the
    twin's work counts; clusters of both kinds (and a super level where
    asked) are really walked. The large scenes take the render driver's tables,
    their ground primitive in a super of its own; the warp-union counts
    are never below the per-lane ones."""
    if kw is None:
        scene, cam, st = small_large_scene(name)
        scene_cl, cs = pdriver.cluster_for_render(scene, cam)
        fine = cs.sph if name == "rand_spheres_large" else cs.quad
        assert int(((fine[:, 3] - fine[:, 0] >= 1000) & (fine[:, 7] == 1)).sum()) == 1
    else:
        scene, cam, st = port_scene(name)
        scene_cl, cs = pbvh.cluster_scene(scene, **kw)
        if front_to_back:
            cs = pdriver.order_clusters(cs, cam.look_from.numpy())
    log_d, segs_d = twin(scene, cam, st)
    table = ppk.pack_cluster_table(cs)
    if kw is None:
        assert (table.n_sph_super if name == "rand_spheres_large" else table.n_quad_super) > 1
    else:
        assert table.n_quad >= 1 and (table.n_sph > 1 or name == "image_quad_field")
    if kw is not None and kw.get("min_fine_for_super", 24) <= 8:
        assert table.n_quad_super > 1
    log_c, segs_c = twin(scene_cl, cam, st, table)
    assert torch.equal(log_d, log_c) and torch.equal(segs_d, segs_c)
    log_w, segs_w, work, warp_work = twin(scene_cl, cam, st, table, return_work=True)
    assert torch.equal(log_d, log_w) and torch.equal(segs_d, segs_w)
    assert work.shape == (6, segs_w.shape[0]) and work.dtype == torch.int32
    assert warp_work.shape == (7,) and warp_work.dtype == torch.int64
    assert (warp_work[:6] * 32 >= work.long().sum(1)).all()
    segments = int(segs_w.sum())
    assert 0 < int(warp_work[6]) <= segments
    assert (work[3] <= work[1]).all() and (work[5] <= work[4]).all() and (work[4] <= work[2]).all()
    sphere_tests = int(work[1].sum())
    if name not in ("image_quad_field", "quad_field"):  # a dummy sphere no ray enters
        assert sphere_tests > 0
    assert sphere_tests <= segments * scene_cl.num_spheres
    assert 0 < int(work[2].sum()) <= segments * scene_cl.num_quads
    assert int(work[0].sum()) >= segments * (table.n_sph_super or table.n_sph)


def walk_culled(table, sph, quad, o, d, warp=None):
    """Kernel 2's culled closest hit as the kernel runs it: cluster by
    cluster in visit order, each ray testing a cluster's primitives only
    when its slab test against its own running best enters (vectorized
    over rays, sequential over clusters). Returns (t, prim, work (3, N))
    and, given each ray's warp `warp` (N,), also the (3,) tests that the
    warps pay: a warp runs each test any of its rays runs."""
    n = o.shape[0]
    t_best = torch.full((n,), float("inf"))
    p_best = torch.full((n,), -1, dtype=torch.int64)
    work = torch.zeros(3, n, dtype=torch.int64)
    warp_work = torch.zeros(3, dtype=torch.int64)

    def warps_in(mask):  # warps with a ray in `mask`
        if warp is None:
            return 0
        return int(torch.zeros(int(warp.max()) + 1).index_add_(0, warp, mask.float()).gt(0).sum())
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv = pik.slab_inv(d)
    rows = table.rows
    s_super, s_fine, q_super, q_fine = table.counts
    ns = sph.shape[0]

    def enters(r):
        return pcv._slab_enters(rows[r : r + 1, :6], o, inv, a, t_best[:, None])[:, 0]

    def test_range(kind, begin, end, mask):
        nonlocal t_best, p_best
        tables = (sph[begin:end], quad[:0]) if kind == 0 else (sph[:0], quad[begin:end])
        t_c, p_c, _ = pik.closest_hit_scaled(*tables, o, d)
        better = mask & (t_c < t_best)
        t_best = torch.where(better, t_c, t_best)
        p_best = torch.where(better, begin + p_c.long() + (ns if kind else 0), p_best)
        work[1 + kind] += mask.long() * (end - begin)
        warp_work[1 + kind] += warps_in(mask) * (end - begin)

    for kind, base, n_sup, n_fine, size in ((0, 0, s_super, s_fine, ns),
                                            (1, s_super + s_fine, q_super, q_fine,
                                             quad.shape[0])):
        if n_fine == 0:
            test_range(kind, 0, size, torch.ones(n, dtype=torch.bool))
            continue
        supers = range(n_sup) if n_sup else [None]
        for si in supers:
            live = torch.ones(n, dtype=torch.bool)
            fines = range(n_fine)
            if si is not None:
                work[0] += 1
                warp_work[0] += warps_in(torch.ones(n, dtype=torch.bool))
                live = enters(base + si)
                s0, c0 = int(rows[base + si, 6]), int(rows[base + si, 7])
                fines = range(s0, s0 + c0)
            for fi in fines:
                r = base + n_sup + fi
                work[0] += live.long()
                warp_work[0] += warps_in(live)
                m = live & enters(r)
                test_range(kind, int(rows[r, 6]), int(rows[r, 6] + rows[r, 7]), m)
    t = t_best * (1.0 / a)
    prim = torch.where(t_best < float("inf"), p_best, -1).to(torch.int32)
    return (t, prim, work) if warp is None else (t, prim, work, warp_work)


@pytest.mark.parametrize("name,kw,front_to_back", TWIN_CASES)
def test_visit_twin_equals_culling_walk(name, kw, front_to_back):
    """ClusterVisit (dense search in visit order; work from the running
    best of every earlier row) against walk_culled, which really skips
    clusters: t, prim and the three work counts equal on rays from inside
    and around the scene."""
    scene, cam, st = port_scene(name)
    scene_cl, cs = pbvh.cluster_scene(scene, **kw)
    if front_to_back:
        cs = pdriver.order_clusters(cs, cam.look_from.numpy())
    table = ppk.pack_cluster_table(cs)
    sph, quad, _ = ppk.pack_persistent_tables(scene_cl)
    rng = np.random.default_rng(7)
    o = torch.from_numpy(rng.uniform(-9, 9, (3000, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(-9, 9, (3000, 3)).astype(np.float32))
    d = tgt - o
    d[:200, :2] = 0.0  # axis-parallel rays: the slab test's nudged inverse
    visit = pcv.ClusterVisit.build(table, sph, quad)
    t_v, p_v, w_v = visit.hit_work(o, d)
    t_w, p_w, w_w = walk_culled(table, sph, quad, o, d)
    assert torch.equal(t_v, t_w) and torch.equal(p_v, p_w)
    assert torch.equal(w_v[:3], w_w)
    t_h, p_h = visit.hit(o, d)
    assert torch.equal(t_h, t_v) and torch.equal(p_h, p_v)
    assert int((p_v >= 0).sum()) > 100


@pytest.mark.parametrize("name,kw,front_to_back", TWIN_CASES[1:3])
def test_warp_union_work_equals_the_culling_walk(name, kw, front_to_back):
    """ClusterVisit.hit_work's warp-union counts against walk_culled's
    (which counts, cluster by cluster, the warps with a ray in each test):
    equal with 32 consecutive rays a warp; with one ray a warp they are the
    per-ray counts (x 32 in lane slots: each lane pays a whole warp), and
    never below them with 32."""
    scene, cam, st = port_scene(name)
    scene_cl, cs = pbvh.cluster_scene(scene, **kw)
    if front_to_back:
        cs = pdriver.order_clusters(cs, cam.look_from.numpy())
    table = ppk.pack_cluster_table(cs)
    sph, quad, _ = ppk.pack_persistent_tables(scene_cl)
    rng = np.random.default_rng(9)
    o = torch.from_numpy(rng.uniform(-9, 9, (2000, 3)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(-9, 9, (2000, 3)).astype(np.float32)) - o
    visit = pcv.ClusterVisit.build(table, sph, quad)
    lanes = torch.arange(2000)
    _, _, per_ray = visit.hit_work(o, d)
    _, _, per_ray_1, one = visit.hit_work(o, d, warp=lanes)
    assert torch.equal(per_ray_1, per_ray)
    assert one.tolist() == per_ray.sum(1).tolist() + [2000]
    _, _, _, union = visit.hit_work(o, d, warp=lanes // 32)
    assert union[6] == 63 and (union[:6] * 32 >= per_ray.sum(1)).all()
    assert (union[:3] < per_ray[:3].sum(1)).all()  # warps share clusters
    _, _, walk_work, walk_union = walk_culled(table, sph, quad, o, d, warp=lanes // 32)
    assert torch.equal(walk_work, per_ray[:3]) and torch.equal(walk_union, union[:3])


def test_clustered_twin_matches_jax_trace():
    """The clustered twin on the permuted 6x6 grid (one sample per lane,
    russian roulette off) against JAX `trace` of the original scene fed the
    same counter-RNG uniforms, at tests/test_torch_integrator.py's
    tolerance: rtol 1e-4 / atol 1e-5 on >= 99.5% of lanes, the mean within
    1e-4."""
    width, max_depth = 24, 6
    jsc, kw = grid_6x6(jscene.SceneBuilder(0))
    kw = dict(kw, max_depth=max_depth)
    jc, _ = jcam.make_camera(1.0, width, **kw)
    scene, cam, st = port_scene("grid_6x6", width)
    st = st._replace(max_depth=max_depth)
    scene_cl, cs = pbvh.cluster_scene(scene, max_leaf=8)
    n_pix = st.width * st.height
    log, segs = twin(scene_cl, cam, st, ppk.pack_cluster_table(pdriver.order_clusters(cs, cam.look_from.numpy())),
                     spp=1, wavefront=n_pix, rr_start=max_depth, seed=12345)
    got = log[:, 0, :].T.numpy()
    sids = jnp.arange(n_pix, dtype=jnp.int32)
    o, d = jcam.camera_rays(jcam.camera_frame(jc, st.width, st.height), sids % st.width,
                            sids // st.width, jrng.camera_uniforms(12345, sids))
    want = np.asarray(jwf.trace(jsc, o, d, jax.random.PRNGKey(0), jc.background,
                                max_depth=max_depth,
                                uniform_seq=jrng.bounce_uniform_seq(12345, sids, max_depth)))
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-4)
    assert (want > 0).any(axis=1).mean() > 0.5 and int(segs.max()) > 1


def test_render_persistent_cluster_arguments():
    """The wrapper checks the table like the other tables, the twin
    refuses work counts without clusters, and an empty set packs as one
    zero row."""
    scene, cam, st = port_scene("grid_6x6", 8)
    table = ppk.pack_cluster_table(pbvh.cluster_scene(scene, max_leaf=8)[1])
    with pytest.raises(ValueError, match="return_work"):
        twin(scene, cam, st, return_work=True)
    with pytest.raises(TypeError, match="clusters.rows"):
        twin(scene, cam, st, table._replace(rows=table.rows.double()))
    with pytest.raises(ValueError, match="do not fit"):
        twin(scene, cam, st, table._replace(n_sph=table.rows.shape[0]))
    empty = ppk.pack_cluster_table(pbvh.ClusterSet(*(np.zeros((0, 8), np.float32),) * 4))
    assert empty.rows.shape == (1, 8) and empty.counts == (0, 0, 0, 0)
    # No rows of either kind: the dense loops, the dense twin's image.
    log_e, segs_e = twin(scene, cam, st, empty)
    log_d, segs_d = twin(scene, cam, st)
    assert torch.equal(log_e, log_d) and torch.equal(segs_e, segs_d)


@pytest.mark.parametrize("name,kw", [("rand_spheres_large", {"n_spheres": 3000}),
                                     ("quad_field", {"n_spheres": 3000})])
def test_large_scene_renders_clustered_on_the_persistent_path(name, kw):
    """A scene past CLUSTERED_SCENE_PRIMS renders through the persistent
    path with the cluster table (the metrics say so, and which builder
    ran); its image equals the dense twin's on the same permuted scene."""
    scene, cam, st = getattr(pbuilders, name)(width=16, spp=2, max_depth=4, **kw)
    assert scene.num_prims > ppk.CLUSTERED_SCENE_PRIMS
    assert pdriver.render_path(scene) == "persistent"
    metrics = RenderMetrics(total_spp=2, pixels=st.width * st.height)
    img = pdriver.render_image(scene, cam, st, device="cpu", seed=4, metrics=metrics)
    snap = metrics.snapshot()
    assert snap["bvh_builder"] == "native" and snap["cluster_s"] > 0
    assert snap["cluster_rows"][1 if name == "rand_spheres_large" else 3] > 1
    assert "iterations" not in snap and 0 < snap["warp_occupancy"] <= 1
    scene_cl, _ = pdriver.cluster_for_render(scene, cam)
    w, h = st.width, st.height
    n, num_slots, jump = pwf.strided_schedule(w * h, 2, pdriver.DEFAULT_WAVEFRONT)
    log, _ = twin(scene_cl, cam, st, wavefront=pdriver.DEFAULT_WAVEFRONT, seed=4)
    want = pwf._fold_log(log, num_slots, n, w * h, jump) / 2
    assert torch.equal(img.reshape(-1, 3), want)


# Bounce rays of the large renders' kernel calls (400x225, 2^18 lanes,
# seed 0, clustered at the JAX driver's granularity) on which the
# unpadded slab test of kernel 2's cull parts from the dense search: each
# leaves the top of a sphere (or the ground) and the
# expanded-form sphere test re-hits that surface just past T_MIN, at a
# point outside the sphere's own cluster box. (scene overrides, origin,
# direction, the dense winner.)
SELF_REHIT_RAYS = [
    ({}, (-25.429901123046875, 0.39989137649536133, -29.437808990478516),
     (0.6389104127883911, 0.23958516120910645, 0.2631728947162628), 1541),
    ({}, (-42.48151397705078, 0.00024068355560302734, -24.260011672973633),
     (-0.6032102108001709, -0.4797218441963196, 0.5437122583389282), 784),
    ({"n_spheres": 50000}, (-49.86518859863281, 0.3989136219024658, 3.8440113067626953),
     (0.7439562082290649, 1.145668864250183, -0.529119074344635), 18795),
]


@pytest.mark.parametrize("scene_kw,origin,direction,winner", SELF_REHIT_RAYS)
def test_slab_pad_keeps_the_dense_winner_of_a_self_rehit(scene_kw, origin, direction, winner,
                                                         monkeypatch):
    """utils/cull_divergence.py on one such ray, on the tables it was found
    on (the JAX driver's granularity): the unpadded cull drops the dense
    winner, kernel 2's pad (CLUSTER_SLAB_PAD) keeps it."""
    from raytracer_tpu_torch.utils.cull_divergence import divergent_rays

    jax_granularity(monkeypatch)

    scene, cam, _ = pbuilders.rand_spheres_large(width=32, **scene_kw)
    scene_cl, cs = pdriver.cluster_for_render(scene, cam)
    sph, quad, _ = ppk.pack_persistent_tables(scene_cl)
    visit = pcv.ClusterVisit.build(ppk.pack_cluster_table(cs), sph, quad)
    o, d = torch.tensor([origin]), torch.tensor([direction])
    assert int(visit.hit(o, d)[1]) == winner
    assert divergent_rays(visit, o, d, (0.0, ppk.CLUSTER_SLAB_PAD)) == {
        0.0: 1, ppk.CLUSTER_SLAB_PAD: 0}


def test_cull_divergence_counts_a_clustered_render():
    """The utility's count on a small clustered render: the twin's
    segments, and one count per pad, none at kernel 2's pad."""
    from raytracer_tpu_torch.utils.cull_divergence import count

    scene, cam, st = pbuilders.rand_spheres_large(width=24, spp=2, n_spheres=3000)
    out = count(scene, cam, st, device="cpu", pads=(0.0, ppk.CLUSTER_SLAB_PAD), wavefront=512)
    scene_cl, cs = pdriver.cluster_for_render(scene, cam)
    _, segs = twin(scene_cl, cam, st, ppk.pack_cluster_table(cs), wavefront=512, seed=0)
    assert out["segments"] == int(segs.sum()) > 0
    assert sorted(out["divergent_rays_by_pad"]) == ["0.0", str(ppk.CLUSTER_SLAB_PAD)]
    assert out["divergent_rays_by_pad"][str(ppk.CLUSTER_SLAB_PAD)] == 0
