"""The port's CUDA kernels against their plain PyTorch twins, and the wrapper
and build plumbing around them.

Tests marked `cuda` need an NVIDIA GPU and skip without one. This file
imports no jax, so on a machine with a card (and no jax) it runs alone:

    python -m pytest --noconftest -o markers="cuda: needs a CUDA device" \\
        -m cuda tests/test_torch_kernels.py
"""

import shutil

import numpy as np
import pytest
import torch

from adversarial_quads import adversarial_quad_rays, early_out_quad_hits
from cluster_scenes import SCENES as CLUSTER_SCENES
from cluster_scenes import TWIN_CASES
from raytracer_tpu_torch.core.camera import camera_frame, camera_rays, make_camera
from raytracer_tpu_torch.geometry.bvh import ClusterSet, cluster_scene
from raytracer_tpu_torch.geometry.intersect import quad_derived, scene_tables
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.integrator import wavefront as wf
from raytracer_tpu_torch.materials.packed import texture_tables
from raytracer_tpu_torch.ops import build, ctr_rng
from raytracer_tpu_torch.ops import cluster_visit as cv
from raytracer_tpu_torch.ops import culled_kernel as ck
from raytracer_tpu_torch.ops import intersect_kernel as ik
from raytracer_tpu_torch.ops import persistent_kernel as pk
from raytracer_tpu_torch.ops import wavefront_kernel as wk
from raytracer_tpu_torch.render.driver import cluster_for_render, order_clusters
from raytracer_tpu_torch.scenes.registry import get_scene

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_rays(n, lo, hi, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = (rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o).astype(np.float32)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def textured_quads(seed=0, width=48, spp=4, max_depth=10, bilinear=False):
    """Images and noise on spheres and quads, a checker and a metal (read as
    solid), lit by a noise emitter: every texture kind on both UV paths."""
    b = SceneBuilder(seed)
    img = np.random.default_rng(2).uniform(0, 1, (6, 10, 3))
    b.add_sphere((0, -100.5, -1), 100, b.lambertian(b.noise(3.0)))
    b.add_sphere((0, 0, -1), 0.5, b.lambertian(b.image(img)))
    b.add_sphere((-1.1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.add_sphere((1.1, 0.8, -1), 0.3, b.diffuse_light(b.noise(1.5)))
    b.add_quad((-2, -0.4, -2.5), (4, 0, 0), (0, 2, 0), b.lambertian(b.image(img[:4, :7])))
    b.add_quad((-1, -0.5, 0.5), (1, 0, 0), (0, 0, -1), b.lambertian(b.noise(5.0)))
    b.add_quad((1, -0.5, 0.5), (1, 0, 0), (0, 0, -1),
               b.lambertian(b.checker(0.2, (1, 0, 0), (0, 1, 0))))
    cam, st = make_camera(16 / 9, width, samples_per_pixel=spp, max_depth=max_depth,
                          look_from=(0, 0.5, 2), look_at=(0, 0, -1), fov_degrees=70,
                          background=(0.3, 0.4, 0.5))
    return b.build(bilinear_textures=bilinear), cam, st


def scene_by_name(name, **kw):
    """A registered scene, "textured_quads" (its bilinear flag in kw), or a
    scene of tests/cluster_scenes.py."""
    if name == "textured_quads":
        return textured_quads(**kw)
    if name in CLUSTER_SCENES:
        scene, cam_kw = CLUSTER_SCENES[name](SceneBuilder(0))
        cam, st = make_camera(1.0, kw["width"], **dict(
            cam_kw, samples_per_pixel=kw["spp"], max_depth=kw["max_depth"]))
        return scene, cam, st
    return get_scene(name, **kw)


def clustered(scene, cam, cluster_kw, front_to_back):
    """(permuted scene, ClusterSet): render_image's clustering for None,
    else cluster_scene(**cluster_kw), its rows sorted front to back if
    asked."""
    if cluster_kw is None:
        return cluster_for_render(scene, cam)
    scene, cs = cluster_scene(scene, **cluster_kw)
    return scene, order_clusters(cs, cam.look_from.numpy()) if front_to_back else cs


def persistent_inputs(name, width, spp, wavefront, device, max_depth=10, stochastic=False,
                      cluster=False, cluster_kw=None, front_to_back=True, **scene_kw):
    """Kernel 2's arguments and config for `name`; the config carries the
    texture tables (None for untextured scenes) and, with `cluster`, the
    cluster table of the permuted scene (`clustered`)."""
    scene, cam, st = scene_by_name(name, width=width, spp=spp, max_depth=max_depth, **scene_kw)
    cl = None
    if cluster:
        scene, cs = clustered(scene, cam, cluster_kw, front_to_back)
        cl = pk.pack_cluster_table(cs, device)
    n_pix = st.width * st.height
    n, num_slots, jump = wf.strided_schedule(n_pix, spp, wavefront)
    rem0, px0, py0 = wf.schedule_arrays(n, n_pix, spp, st.width, device=device)
    sph, quad, res = pk.pack_persistent_tables(scene.to(device))
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, st.width, st.height),
                                      cam.background).to(device)
    cfg = dict(width=st.width, height=st.height, jump_px=jump % st.width,
               jump_py=jump // st.width, num_slots=num_slots, max_depth=max_depth,
               sky_gradient=st.sky_gradient)
    sc = scene.to(device)
    textures = texture_tables(sc, quad_derived(sc), stochastic=stochastic)
    if textures is not None:
        cfg["textures"] = textures
    if cl is not None:
        cfg["clusters"] = cl
    return (sph, quad, res, cam_s, 5, rem0, px0, py0), cfg


# Kernel 2 culled: the JAX package's culling scenes (cluster_scene
# arguments, front-to-back order), and the large registered scenes at a
# reduced image with render_image's clustering.
CULLED = [(name, kw, ftb, {}) for name, kw, ftb in TWIN_CASES] + [
    ("rand_spheres_large", None, True, {}),
    ("quad_field", None, True, {}),
    ("rand_spheres_large", None, True, {"n_spheres": 50000}),
]


def culled_pair(name, kw, ftb, scene_kw, device, width=48, spp=4):
    """Kernel 2 culled and its twin, each returning (log, segs)."""
    args, cfg = persistent_inputs(name, width, spp, 2000, device, max_depth=8, cluster=True,
                                  cluster_kw=kw, front_to_back=ftb, **scene_kw)

    def kernel():
        return pk.render_persistent(*args, **cfg)

    def plain():
        return wf.regen_plain(*args, **cfg, rr_start=5, rr_lo=0.05, rr_hi=0.75,
                              max_iters=pk.max_iters_for(cfg["num_slots"], 8))

    return kernel, plain


@pytest.mark.cuda
@pytest.mark.parametrize("name,lo,hi", [("rand_spheres", (-12, 0.05, -12), (12, 6, 12)),
                                        ("cornell", (1, 1, 1), (554, 554, 554))])
def test_intersect_kernel_matches_plain(cuda, name, lo, hi):
    """prim equal on >= 99.99% of rays, t rtol 1e-5 where it is (built
    without contraction the kernel rounds like its twin)."""
    sph, quad = scene_tables(get_scene(name)[0].to(cuda))
    o, d = random_rays(1 << 18, lo, hi, seed=3, device=cuda)
    before = ik.LAUNCHES
    t_k, p_k = ik.intersect(sph, quad, o, d)
    assert ik.LAUNCHES == before + 1
    t_p, p_p = ik.intersect_plain(sph, quad, o, d)
    assert ik.LAUNCHES == before + 1
    torch.cuda.synchronize()
    same = p_k == p_p
    assert float(same.float().mean()) >= 0.9999
    fin = same & torch.isfinite(t_p)
    torch.testing.assert_close(t_k[fin], t_p[fin], rtol=1e-5, atol=0.0)
    assert bool((torch.isinf(t_k[same]) == torch.isinf(t_p[same])).all())


def adversarial_rays():
    """(sphere table (S, 4), origins (N, 3), directions (N, 3)) float32, rays
    built to reach every branch of the sphere candidate: rays leaving a
    sphere's surface (entering it again just past T_MIN), tangent rays whose
    discriminant is exactly 0 (integer coordinates, |d| 1 and 2) or one
    float32 step either side of it, a dummy row (1e30), directions of
    length ~1e-20, rays inside the r = 1000 ground sphere, and huge rays
    whose discriminant is inf - inf = NaN."""
    f32 = np.float32
    rng = np.random.default_rng(11)
    centers = np.array([[0, -1000, 0], [0, 0, 0], [4, 0, 0], [0, 0, 7], [0, 0, 0]], f32)
    radii = np.array([1000, 1, 2, 1, 0], f32)  # the last row is a dummy
    sph = ik.pack_sphere_table(torch.from_numpy(centers), torch.from_numpy(radii)).numpy()
    o, d = [], []
    for c, r in zip(centers[1:4], radii[1:4]):  # tangent: |o_perp - c| = r exactly
        for k in (3, 5, 9):
            for scale in (1, 2):
                for axis, off in ((0, 1), (2, 1)):
                    dv = np.zeros(3, f32)
                    dv[axis] = scale
                    ov = c.copy()
                    ov[axis] -= k
                    ov[1] += r
                    o.append(ov)
                    d.append(dv)
                    o.append(np.nextafter(ov, ov + off).astype(f32))  # a step either side
                    d.append(dv)
                    o.append(np.nextafter(ov, ov - off).astype(f32))
                    d.append(dv)
    for _ in range(200):  # leaving (or just short of) the unit sphere's surface
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        step = rng.choice([9e-4, 1e-3, 1.0001e-3, 1.1e-3, 0.0])
        o.append((n - n * step).astype(f32))
        d.append((n * rng.uniform(0.5, 2)).astype(f32))
        o.append((n + n * step).astype(f32))
        d.append((-n * rng.uniform(0.5, 2)).astype(f32))
    for _ in range(100):  # tiny directions, inside the ground, huge
        o.append(rng.uniform(-3, 3, 3).astype(f32))
        d.append((rng.normal(size=3) * 1e-20).astype(f32))
        o.append(np.array([rng.uniform(-50, 50), rng.uniform(-900, -1), rng.uniform(-50, 50)],
                          f32))
        d.append(rng.normal(size=3).astype(f32))
        o.append((rng.normal(size=3) * 1e10).astype(f32))
        d.append((rng.normal(size=3) * 1e10).astype(f32))
    return sph, np.stack(o).astype(f32), np.stack(d).astype(f32)


def masked_sphere_candidates(sph, o, d, root=np.sqrt):
    """NumPy float32 reference of csrc/closest_hit.cuh:sphere_candidate, term
    by term in the kernel's order: the root of 1.0 and a +inf candidate
    where the discriminant is not >= 0. `root` is the square root."""
    f32 = np.float32
    with np.errstate(all="ignore"):
        ox, oy, oz = (o[:, i:i + 1] for i in range(3))
        dx, dy, dz = (d[:, i:i + 1] for i in range(3))
        a = dx * dx + dy * dy + dz * dz
        d_dot_o = dx * ox + dy * oy + dz * oz
        o_sq = ox * ox + oy * oy + oz * oz
        tmin_a = f32(ik.T_MIN) * a
        cx, cy, cz, c2r2 = (sph[None, :, i] for i in range(4))
        half_b = d_dot_o - (dx * cx + dy * cy + dz * cz)
        c = o_sq - f32(2.0) * (ox * cx + oy * cy + oz * cz) + c2r2
        disc = half_b * half_b - a * c
        real = disc >= 0
        sq = root(np.where(real, disc, f32(1.0)))
        t0s, t1s = -half_b - sq, -half_b + sq
        t = np.where(t0s > tmin_a, t0s, np.where(t1s > tmin_a, t1s, f32(np.inf)))
        return np.where(real, t, f32(np.inf)).astype(f32), disc


def test_masked_sphere_candidates_equal_the_twin():
    """The kernel's masked sphere candidate (a NumPy float32 reference of
    closest_hit.cuh) against the twin's unmasked one
    (candidates_scaled: torch.sqrt of a negative discriminant, NaN compares
    falling through): every scaled t bit-equal on adversarial rays that
    reach discriminants of exactly 0, one step either side, NaN, and
    candidates just past T_MIN. The reference takes the twin's own root:
    torch's float32 sqrt on the CPU is not always correctly rounded (it is
    one step off NumPy's on a few of these discriminants), while on the
    card torch.sqrt and the kernel's sqrtf both are."""
    sph, o, d = adversarial_rays()
    want, disc = masked_sphere_candidates(
        sph, o, d, root=lambda x: torch.sqrt(torch.from_numpy(x)).numpy())
    got, _ = ik.candidates_scaled(torch.from_numpy(sph), torch.zeros(0, 12),
                                  torch.from_numpy(o), torch.from_numpy(d))
    assert np.array_equal(got.numpy(), want)
    assert (disc == 0).sum() >= 30 and np.isnan(disc).sum() >= 50 and (disc < 0).sum() > 0
    a = (d * d).sum(1, keepdims=True)
    near = np.isfinite(want) & (want < 2e-3 * a)
    assert near.sum() >= 50 and (np.isfinite(want) & (want == 0)).sum() == 0


@pytest.mark.cuda
def test_intersect_kernel_tangent_rays_match_plain(cuda):
    """Kernel 1 on adversarial_rays' table and rays (exact-zero and NaN
    discriminants, hits just past T_MIN): t and prim bit-equal to the
    twin."""
    sph, o, d = (torch.from_numpy(x).to(cuda) for x in adversarial_rays())
    quad = torch.zeros(1, 12, device=cuda)
    t_k, p_k = ik.intersect(sph, quad, o, d)
    t_p, p_p = ik.intersect_plain(sph, quad, o, d)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p) and torch.equal(t_k.isnan(), t_p.isnan())
    assert torch.equal(torch.nan_to_num(t_k), torch.nan_to_num(t_p))


def test_quad_early_out_equals_the_twin():
    """The quad test in early-out form (tests/adversarial_quads.py's NumPy
    float32 reference: no division for a plane that does not face the ray,
    no in-quad test for a t that cannot win; the work the culled bounds
    count as needed) against the twin's full test (intersect_plain): t
    bit-equal (NaN where the twin's is) and the same winner on rays that
    reach num = +-0, |d.n| at and below QUAD_DENOM_EPS, t at T_MIN,
    back-facing planes, in-quad coordinates of 0 and 1, NaN directions and
    ties: the skipped work changes no result."""
    table, o, d = adversarial_quad_rays()
    want_t, want_p, _, _ = early_out_quad_hits(table, o, d)
    got_t, got_p = ik.intersect_plain(torch.zeros(0, 4), torch.from_numpy(table),
                                      torch.from_numpy(o), torch.from_numpy(d))
    assert np.array_equal(got_p.numpy(), want_p)
    assert np.array_equal(got_t.numpy(), want_t, equal_nan=True)
    cands, _ = ik.candidates_scaled(torch.zeros(0, 4), torch.from_numpy(table),
                                    torch.from_numpy(o), torch.from_numpy(d))
    c = cands.numpy()
    tied = ((c == c.min(axis=1, keepdims=True)) & np.isfinite(c)).sum(axis=1) >= 2
    assert tied.sum() >= 10 and (want_p >= 0).sum() >= 100 and np.isnan(want_t).sum() >= 2


def test_twin_counts_the_early_out_quad_work():
    """The culled twin's data-dependent quad counts (ClusterVisit.hit_work:
    divisions and in-quad tests, the work of kernel 2's culled bound) with
    no cluster rows (both kinds dense) equal, ray by ray, the rows that
    reach each step of the early-out loop (tests/adversarial_quads.py's
    NumPy reference)."""
    table, o, d = adversarial_quad_rays()
    _, want_p, divisions, in_quad = early_out_quad_hits(table, o, d)
    sph = torch.zeros(0, 4)
    quad = torch.from_numpy(table)
    dense = pk.pack_cluster_table(ClusterSet(*(np.zeros((0, 8), np.float32),) * 4))
    visit = cv.ClusterVisit.build(dense, sph, quad)
    _, p, work = visit.hit_work(torch.from_numpy(o), torch.from_numpy(d))
    assert np.array_equal(p.numpy(), want_p)
    assert np.array_equal(work[2].numpy(), np.full(len(o), len(table)))
    assert np.array_equal(work[4].numpy(), divisions)
    assert np.array_equal(work[5].numpy(), in_quad)
    assert 0 < in_quad.sum() < divisions.sum() < work[2].sum()


@pytest.mark.cuda
def test_intersect_kernel_adversarial_quads_match_plain(cuda):
    """Kernel 1 on tests/adversarial_quads.py's table and rays, behind one
    dummy sphere row: t and prim bit-equal to the twin."""
    table, o, d = (torch.from_numpy(x).to(cuda) for x in adversarial_quad_rays())
    sph = ik.pack_sphere_table(torch.zeros(1, 3), torch.zeros(1)).to(cuda)
    t_k, p_k = ik.intersect(sph, table, o, d)
    t_p, p_p = ik.intersect_plain(sph, table, o, d)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p) and torch.equal(t_k.isnan(), t_p.isnan())
    assert torch.equal(torch.nan_to_num(t_k), torch.nan_to_num(t_p))
    assert int((p_k >= 1).sum()) >= 100


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("rand_spheres", {}), ("cornell", {}),
                                     ("quad_field", {"n_spheres": 1534})])
def test_persistent_kernel_dense_matches_plain_bit_for_bit(cuda, name, kw):
    """Kernel 2's dense instantiation (the grouped sphere loop) on spheres
    only, on quads only (cornell) and at 1,536 primitives (quad_field cut to
    1,534 tiles, the most a dense render serves): log and segments
    bit-equal to the twin."""
    args, cfg = persistent_inputs(name, 48, 4, 2000, cuda, max_depth=10, **kw)
    assert args[0].shape[0] + args[1].shape[0] <= pk.CLUSTERED_SCENE_PRIMS
    log_k, segs_k = pk.render_persistent(*args, **cfg)
    log_p, segs_p = wf.regen_plain(
        *args, **cfg, rr_start=5, rr_lo=0.05, rr_hi=0.75,
        max_iters=pk.max_iters_for(cfg["num_slots"], cfg["max_depth"]),
    )
    torch.cuda.synchronize()
    assert torch.equal(log_k, log_p) and torch.equal(segs_k, segs_p), equal_report(
        [("log", log_k, log_p), ("segs", segs_k, segs_p)])
    assert float(log_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rand_spheres", "cornell", "one_weekend_final"])
def test_persistent_kernel_matches_plain(cuda, name):
    """Same tables, schedule and seed: per-(slot, lane) radiance within
    rtol 1e-3 on >= 99% of cells, segments within 0.1%."""
    args, cfg = persistent_inputs(name, 48, 4, 2000, cuda)
    before = pk.LAUNCHES
    log_k, segs_k = pk.render_persistent(*args, **cfg)
    assert pk.LAUNCHES == before + 1
    log_p, segs_p = wf.regen_plain(
        *args, **cfg, rr_start=5, rr_lo=0.05, rr_hi=0.75,
        max_iters=pk.max_iters_for(cfg["num_slots"], cfg["max_depth"]),
    )
    torch.cuda.synchronize()
    close = torch.isclose(log_k, log_p, rtol=1e-3, atol=1e-6).all(dim=0)
    assert float(close.float().mean()) >= 0.99
    sk, sp = int(segs_k.sum()), int(segs_p.sum())
    assert abs(sk - sp) <= 1e-3 * sp


def tape_inputs(name, width, device, **scene_kw):
    """Kernel 3's tables, the settings, and the texture tables (or None)."""
    scene, cam, st = scene_by_name(name, width=width, **scene_kw)
    sc = scene.to(device)
    sph, quad, res = pk.pack_persistent_tables(sc)
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, st.width, st.height),
                                      cam.background).to(device)
    return (sph, quad, res, cam_s), st, texture_tables(sc, quad_derived(sc))


@pytest.mark.cuda
@pytest.mark.parametrize("name,width,spp,depth,n", [
    ("rand_spheres", 96, 2, 50, None),
    ("cornell", 48, 2, 12, None),
    ("rand_spheres", 96, 2, 50, 1),  # one sample: one thread of one block
    ("rand_spheres", 96, 2, 50, 1001),  # below one resident grid, not a multiple of THREADS
    ("rand_spheres", 400, 2, 50, None),  # 180,000 samples: more than one resident grid
])
def test_tape_kernel_matches_plain(cuda, name, width, spp, depth, n):
    """Kernel 3 (samples from its queue) against its twin on the same CUDA
    tables and seed: tape equal on every entry, radiance and segments equal
    on every sample; the per-thread segments sum to the samples'."""
    tables, st, _ = tape_inputs(name, width, cuda)
    n = n or st.width * st.height * spp
    cfg = dict(width=st.width, height=st.height, max_depth=depth, sky_gradient=st.sky_gradient)
    before = pk.LAUNCHES_TAPE
    rad_k, tape_k, segs_k, per_thread = pk.render_persistent_tape(*tables, 9, n, **cfg,
                                                                  thread_segments=True)
    assert pk.LAUNCHES_TAPE == before + 1
    rad_p, tape_p, segs_p = wf.trace_tape_plain(*tables, 9, n, **cfg)
    torch.cuda.synchronize()
    assert torch.equal(tape_k, tape_p)
    torch.testing.assert_close(rad_k, rad_p, rtol=0, atol=0)
    assert torch.equal(segs_k, segs_p)
    assert int(per_thread.sum()) == int(segs_k.sum())
    assert per_thread.shape[0] % pk.THREADS == 0 and per_thread.shape[0] >= min(n, pk.THREADS)


def equal_report(pairs):
    """'name: equal share, max |diff|' of each (name, kernel, twin) pair."""
    return "; ".join(f"{k}: {float((a == b).float().mean()):.6f} equal, max |diff| "
                     f"{float((a.double() - b.double()).abs().max()):.3g}" for k, a, b in pairs)


TEXTURED = [("perlin", {}), ("simple_light", {}), ("earth", {}),
            ("earth", {"bilinear": True}), ("earth", {"bilinear": True, "stochastic": True}),
            ("textured_quads", {}), ("textured_quads", {"bilinear": True}),
            ("textured_quads", {"bilinear": True, "stochastic": True})]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", TEXTURED)
def test_persistent_kernel_textured_matches_plain(cuda, name, kw):
    """The textured instantiation of kernel 2 against its twin on the same
    tables, schedule and seed (noise; images nearest, 4-tap and
    stochastic, on spheres and quads): log and segments bit-equal."""
    args, cfg = persistent_inputs(name, 48, 4, 2000, cuda, **kw)
    assert cfg["textures"] is not None
    before = pk.LAUNCHES
    log_k, segs_k = pk.render_persistent(*args, **cfg)
    assert pk.LAUNCHES == before + 1
    log_p, segs_p = wf.regen_plain(
        *args, **cfg, rr_start=5, rr_lo=0.05, rr_hi=0.75,
        max_iters=pk.max_iters_for(cfg["num_slots"], cfg["max_depth"]),
    )
    torch.cuda.synchronize()
    assert torch.equal(log_k, log_p) and torch.equal(segs_k, segs_p), equal_report(
        [("log", log_k, log_p), ("segs", segs_k, segs_p)])
    assert float(log_k.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,max_iters", [("perlin", None), ("simple_light", None),
                                            ("perlin", 9), ("simple_light", 9)])
def test_textured_kernels_match_their_twins_lane_by_lane(cuda, name, max_iters, monkeypatch):
    """Kernels 2 and 3 textured (the marble read from the block's shared
    Perlin tables) against their twins, 55 samples a lane: log and every
    lane's segments bit-equal, and the tape, radiance and segments of
    every sample. With `max_iters` the per-lane safety bound cuts kernel
    2's paths mid-render, and must cut each lane at the segment where the
    twin's loop cuts it."""
    if max_iters is not None:
        monkeypatch.setattr(pk, "max_iters_for", lambda slots, depth: max_iters)
    args, cfg = persistent_inputs(name, 40, 16, 256, cuda, max_depth=20)
    log_k, segs_k = pk.render_persistent(*args, **cfg)
    log_p, segs_p = wf.regen_plain(*args, **cfg, rr_start=5, rr_lo=0.05, rr_hi=0.75,
                                   max_iters=pk.max_iters_for(cfg["num_slots"], 20))
    torch.cuda.synchronize()
    assert torch.equal(segs_k, segs_p) and torch.equal(log_k, log_p), equal_report(
        [("log", log_k, log_p), ("segs", segs_k, segs_p)])
    if max_iters is not None:
        assert int(segs_k.max()) == max_iters
        return
    tables, st, textures = tape_inputs(name, 40, cuda)
    tcfg = dict(width=st.width, height=st.height, max_depth=20, sky_gradient=st.sky_gradient,
                textures=textures)
    n = st.width * st.height * 4
    out_k = pk.render_persistent_tape(*tables, 9, n, **tcfg)
    out_p = wf.trace_tape_plain(*tables, 9, n, **tcfg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p)), equal_report(
        [(k, a, b) for k, a, b in zip(("radiance", "tape", "segs"), out_k, out_p)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,n", [("perlin", {}, None), ("earth", {}, None),
                                       ("earth", {"bilinear": True}, None),
                                       ("earth", {"bilinear": True}, 1001),
                                       ("textured_quads", {"bilinear": True}, None)])
def test_tape_kernel_textured_matches_plain(cuda, name, kw, n):
    """Kernel 3's textured instantiation against its twin: tape, radiance
    and segments bit-equal, at depth 20 over 2 samples per pixel (or the n
    given)."""
    tables, st, textures = tape_inputs(name, 48, cuda, **kw)
    assert textures is not None
    n = n or st.width * st.height * 2
    cfg = dict(width=st.width, height=st.height, max_depth=20, sky_gradient=st.sky_gradient,
               textures=textures)
    before = pk.LAUNCHES_TAPE
    rad_k, tape_k, segs_k = pk.render_persistent_tape(*tables, 9, n, **cfg)
    assert pk.LAUNCHES_TAPE == before + 1
    rad_p, tape_p, segs_p = wf.trace_tape_plain(*tables, 9, n, **cfg)
    torch.cuda.synchronize()
    assert (torch.equal(tape_k, tape_p) and torch.equal(rad_k, rad_p)
            and torch.equal(segs_k, segs_p)), equal_report(
        [("tape", tape_k, tape_p), ("radiance", rad_k, rad_p), ("segs", segs_k, segs_p)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,ftb,scene_kw", CULLED)
def test_persistent_kernel_culled_matches_plain(cuda, name, kw, ftb, scene_kw):
    """Kernel 2's culled instantiation against its twin on the same
    permuted tables, cluster table, schedule and seed: log and segments
    bit-equal."""
    kernel, plain = culled_pair(name, kw, ftb, scene_kw, cuda)
    before = pk.LAUNCHES
    out_k = kernel()
    assert pk.LAUNCHES == before + 1
    out_p = plain()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p)), equal_report(
        [("log", out_k[0], out_p[0]), ("segs", out_k[1], out_p[1])])
    assert float(out_k[0].sum()) > 0


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda):
    sph, quad = scene_tables(get_scene("cornell")[0].to(cuda))
    o, d = random_rays(64, (1, 1, 1), (554, 554, 554), seed=0, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        ik.intersect(sph, quad, o, d.cpu())
    args, cfg = persistent_inputs("cornell", 16, 1, 256, cuda)
    sph, quad, res = args[:3]
    shifted = torch.empty(res.numel() + 1, device=cuda)[1:].view_as(res)
    shifted.copy_(res)
    with pytest.raises(ValueError, match="alignment"):
        pk.render_persistent(sph, quad, shifted, *args[3:], **cfg)


def test_cpu_calls_take_the_plain_twin_and_count_nothing():
    sph, quad = scene_tables(get_scene("cornell")[0])
    o, d = random_rays(256, (1, 1, 1), (554, 554, 554), seed=1)
    before = (ik.LAUNCHES, pk.LAUNCHES)
    t, p = ik.intersect(sph, quad, o, d)
    torch.testing.assert_close(t, ik.intersect_plain(sph, quad, o, d)[0], rtol=0, atol=0)
    args, cfg = persistent_inputs("cornell", 16, 2, 300, "cpu", max_depth=4)
    log, segs = pk.render_persistent(*args, **cfg)
    assert log.shape == (3, cfg["num_slots"], 300) and int(segs.sum()) >= 16 * 16 * 2
    assert (ik.LAUNCHES, pk.LAUNCHES) == before


@pytest.mark.parametrize("name,kw,ftb,scene_kw", [CULLED[2], CULLED[4], CULLED[6]])
def test_cpu_culled_call_takes_the_twin_and_counts_nothing(name, kw, ftb, scene_kw):
    """A culled kernel-2 call on CPU tables runs the twin (log, segments
    and work equal to regen_plain's) and counts no launch; the culled
    search equals the dense one on the same permuted tables."""
    kernel, plain = culled_pair(name, kw, ftb, scene_kw, "cpu", width=16, spp=2)
    before = pk.LAUNCHES
    out = kernel()
    assert pk.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(out, plain()))
    args, cfg = persistent_inputs(name, 16, 2, 2000, "cpu", max_depth=8, cluster=True,
                                  cluster_kw=kw, front_to_back=ftb, **scene_kw)
    del cfg["clusters"]
    log_d, segs_d = pk.render_persistent(*args, **cfg)
    assert torch.equal(out[0], log_d) and torch.equal(out[1], segs_d)


def test_cpu_tape_call_takes_the_twin_and_counts_nothing():
    tables, st, _ = tape_inputs("cornell", 16, "cpu")
    n = st.width * st.height
    before = pk.LAUNCHES_TAPE
    rad, tape, segs = pk.render_persistent_tape(*tables, 4, n, width=st.width,
                                                height=st.height, max_depth=5)
    assert pk.LAUNCHES_TAPE == before
    assert rad.shape == (3, n) and tape.shape == (5, n) and tape.dtype == torch.int32
    assert int(tape.max()) < tables[2].shape[0] and int(segs.min()) >= 1
    with pytest.raises(ValueError, match="max_depth"):
        pk.render_persistent_tape(*tables, 4, n, width=st.width, height=st.height, max_depth=0)
    with pytest.raises(ValueError, match="thread_segments"):
        pk.render_persistent_tape(*tables, 4, n, width=st.width, height=st.height, max_depth=5,
                                  thread_segments=True)


def test_cpu_textured_calls_take_the_twin_and_count_nothing():
    """Textured kernel-2 and kernel-3 calls on CPU tables run the twins;
    the tape refuses the stochastic tap (its replay could not repeat it)."""
    args, cfg = persistent_inputs("textured_quads", 16, 2, 300, "cpu", max_depth=4,
                                  bilinear=True, stochastic=True)
    before = (pk.LAUNCHES, pk.LAUNCHES_TAPE)
    log, segs = pk.render_persistent(*args, **cfg)
    ref, _ = wf.regen_plain(*args, **cfg, rr_start=5, rr_lo=0.05, rr_hi=0.75,
                            max_iters=pk.max_iters_for(cfg["num_slots"], 4))
    assert torch.equal(log, ref) and int(segs.sum()) >= 16 * 9 * 2
    tables, st, textures = tape_inputs("textured_quads", 16, "cpu", bilinear=True)
    rad, tape, _ = pk.render_persistent_tape(*tables, 4, 144, width=st.width, height=st.height,
                                             max_depth=4, textures=textures)
    assert bool(torch.isfinite(rad).all()) and int(tape.max()) < tables[2].shape[0]
    assert (pk.LAUNCHES, pk.LAUNCHES_TAPE) == before
    with pytest.raises(ValueError, match="deterministic"):
        pk.render_persistent_tape(*tables, 4, 144, width=st.width, height=st.height,
                                  max_depth=4, textures=cfg["textures"])


def test_wrappers_reject_unsupported_devices():
    sph = torch.zeros(1, 4, device="meta")
    quad = torch.zeros(1, 12, device="meta")
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ik.intersect(sph, quad, o, o)
    args, cfg = persistent_inputs("cornell", 8, 1, 64, "cpu")
    with pytest.raises(TypeError):
        pk.render_persistent(*args[:5], args[5].to(torch.int64), *args[6:], **cfg)


def step_inputs(name, width, device, seed=5):
    """Kernel 5's inputs for a first step (every lane idle) on `name`."""
    scene, cam, st = get_scene(name, width=width, spp=4)
    n_pix = st.width * st.height
    n, _, jump = wf.strided_schedule(n_pix, 4, 1 << 14)
    rem, px, py = wf.schedule_arrays(n, n_pix, 4, st.width, device=device)
    sph, quad, _ = pk.pack_persistent_tables(scene.to(device))
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, st.width, st.height),
                                      cam.background).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    state = [torch.zeros(n, 3, device=device), torch.ones(n, 3, device=device),
             torch.zeros(n, dtype=torch.bool, device=device), rem, px, py,
             torch.full((n,), -1, **i32), torch.zeros(n, **i32)]
    cfg = dict(width=st.width, height=st.height, jump_px=jump % st.width,
               jump_py=jump // st.width, max_depth=st.max_depth)
    return (sph, quad, cam_s, seed, *state), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["perlin", "rand_spheres", "cornell"])
def test_wavefront_step_kernel_matches_plain(cuda, name):
    """Kernel 5 against its twin on the same inputs, a first step and the
    step after it: every output equal."""
    args, cfg = step_inputs(name, 96, cuda)
    for _ in range(2):
        before = wk.LAUNCHES
        out_k = wk.wavefront_step(*args, **cfg)
        assert wk.LAUNCHES == before + 1
        out_p = wk.wavefront_step_plain(*args, **cfg)
        torch.cuda.synchronize()
        for f, a, b in zip(out_k._fields, out_k, out_p):
            assert torch.equal(a, b), f
        # Half the lanes finish, the other half carry on from their hits.
        active = (torch.arange(out_k.t.shape[0], device=cuda) % 2 == 0) & torch.isfinite(out_k.t)
        args = (*args[:4], out_k.origin, out_k.direction, active, out_k.remaining, out_k.px,
                out_k.py, out_k.sample_k, torch.ones_like(out_k.px))


def large_scene_launches(device, monkeypatch, width=96, spp=2, n_spheres=None):
    """The large-scene path on rand_spheres_large (width wide, spp samples,
    one pass) on `device`: (its ClusterTable, sphere and quad tables, the
    (origin, direction) of its kernel-4 launch, the (origin, direction) of
    each of its clustered kernel-1 launches), recorded as the path makes
    them."""
    from raytracer_tpu_torch.render import driver

    kw = {"n_spheres": n_spheres} if n_spheres else {}
    scene, cam, st = get_scene("rand_spheres_large", width=width, spp=spp, **kw)
    calls = {"culled": [], "clustered": []}

    def recorder(kind, real):
        def call(clusters, sph, quad, o, d):
            calls[kind].append((clusters, sph, quad, o.clone(), d.clone()))
            return real(clusters, sph, quad, o, d)
        return call

    monkeypatch.setattr(ck, "intersect_culled", recorder("culled", ck.intersect_culled))
    monkeypatch.setattr(ik, "intersect_clustered",
                        recorder("clustered", ik.intersect_clustered))
    monkeypatch.setattr(driver, "TARGET_RAYS_PER_PASS", spp * st.width * st.height)
    driver.render_loop(scene, cam, st, path="large_scene", device=device, seed=3)
    clusters, sph, quad = calls["culled"][0][:3]
    return (clusters, sph, quad, calls["culled"][0][3:],
            [c[3:] for c in calls["clustered"]])


def assert_t_equal_prim_but_ties(t, p, t_ref, p_ref):
    """t bit-equal on every ray; prim equal except where the two winners
    give the same t exactly (a tie that another visit order breaks the
    other way). Returns the ties."""
    assert torch.equal(t, t_ref)
    ties = int((p != p_ref).sum())
    assert int(((p != p_ref) & (t == t_ref)).sum()) == ties
    return ties


@pytest.mark.cuda
def test_culled_kernel_matches_plain_and_dense(cuda, monkeypatch):
    """Kernel 4 on the large-scene path's own camera rays (rand_spheres_large
    at 96 wide, its two-level cluster table): equal to its twin
    (ClusterVisit.hit) bit for bit, and to dense kernel 1 in t (prim but for
    exact ties)."""
    clusters, sph, quad, (o, d), _ = large_scene_launches(cuda, monkeypatch)
    before = ck.LAUNCHES
    t_k, p_k = ck.intersect_culled(clusters, sph, quad, o, d)
    assert ck.LAUNCHES == before + 1
    t_p, p_p = cv.ClusterVisit.build(clusters, sph, quad).hit(o, d)
    t_1, p_1 = ik.intersect(sph, quad, o, d)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    assert_t_equal_prim_but_ties(t_k, p_k, t_1, p_1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres", [None, 50000])
def test_clustered_kernel_matches_plain_and_dense(cuda, monkeypatch, n_spheres):
    """Kernel 1's clustered entry on every bounce launch of a large-scene
    pass (origins on surfaces, the self re-hits the slab pad exists for):
    equal to ClusterVisit.hit bit for bit, and to dense kernel 1 in t (prim
    but for exact ties)."""
    clusters, sph, quad, _, bounces = large_scene_launches(cuda, monkeypatch,
                                                           n_spheres=n_spheres)
    visit = cv.ClusterVisit.build(clusters, sph, quad)
    assert len(bounces) >= 3
    for o, d in bounces:
        before = ik.LAUNCHES_CLUSTERED
        t_k, p_k = ik.intersect_clustered(clusters, sph, quad, o, d)
        assert ik.LAUNCHES_CLUSTERED == before + 1
        t_p, p_p = visit.hit(o, d)
        t_1, p_1 = ik.intersect(sph, quad, o, d)
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
        assert_t_equal_prim_but_ties(t_k, p_k, t_1, p_1)


def duplicated_rows_scene(seed=4):
    """Tables of 488 spheres (the training scene's row count) whose last 100
    repeat earlier rows, and two quads, one of them repeated: exact ties
    between rows in different slices of a split launch."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-6, 6, (488, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.0, 488).astype(np.float32)
    c[388:], r[388:] = c[:100], r[:100]
    b = SceneBuilder(seed)
    m = b.lambertian((0.5, 0.5, 0.5))
    for ci, ri in zip(c, r):
        b.add_sphere(tuple(ci), float(ri), m)
    for _ in range(2):
        b.add_quad((-7, -7, -7), (14, 0, 0), (0, 14, 0), m)
    return scene_tables(b.build())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 28000, 720000])
def test_intersect_kernel_split_matches_plain(cuda, n):
    """Dense kernel 1 at ray counts from one ray to the scan step's first
    launch, on tables with duplicated rows: t and prim bit-equal to its twin
    whether the launch splits its table or not (split_rows)."""
    sph, quad = (x.to(cuda) for x in duplicated_rows_scene())
    o, d = random_rays(n, (-8, -8, -8), (8, 8, 8), seed=n, device=cuda)
    rows = ik.split_rows(n, sph.shape[0], ik.sm_count(cuda.index or 0))
    assert (rows > 0) == (n <= 28000)
    before = ik.LAUNCHES
    t_k, p_k = ik.intersect(sph, quad, o, d)
    assert ik.LAUNCHES == before + 1
    t_p, p_p = ik.intersect_plain(sph, quad, o, d)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 720000])
def test_intersect_kernel_stable_spheres_match_plain(cuda, n):
    """Dense kernel 1 with the spheres' radii (each sphere winner's t by
    the stable quadratic), split (1000 rays) and in one pass: t and prim
    bit-equal to its twin on rand_spheres' table, on random rays and on
    rays from the eye a hair inside each sphere's silhouette; prim equal to
    the search without the radii."""
    scene = get_scene("rand_spheres")[0].to(cuda)
    sph, quad = scene_tables(scene)
    radius = scene.sph_radius.contiguous()
    o, d = random_rays(n, (-12, 0.05, -12), (12, 6, 12), seed=n, device=cuda)
    eye = torch.tensor([13.0, 2.0, 3.0], device=cuda)
    c = scene.sph_center[1:]
    z = c - eye
    side = torch.linalg.cross(z, torch.tensor([0.0, 1.0, 0.0], device=cuda).expand_as(z))
    side = side / side.norm(dim=1, keepdim=True)
    aim = c + (scene.sph_radius[1:].abs() * 0.99)[:, None] * side
    k = min(n // 2, aim.shape[0])
    o[:k], d[:k] = eye, aim[:k] - eye
    for rays in (o, d):
        assert rays.is_contiguous()
    t_k, p_k = ik.intersect(sph, quad, o, d, radius)
    t_p, p_p = ik.intersect_plain(sph, quad, o, d, radius)
    _, p_0 = ik.intersect(sph, quad, o, d)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p) and torch.equal(p_k, p_0)


@pytest.mark.parametrize("n,slice_rows", [(1, 36), (31, 36), (32, 52), (33, 4), (1000, 100),
                                          (4096, 488), (4096, 500)])
def test_split_combine_equals_the_twin(n, slice_rows):
    """The plain model of the split kernel's combine (each slice's first
    minimal candidate as the word (t bits << 32) | prim, the minimum word)
    equals intersect_plain bit for bit, on tables whose duplicated rows make
    exact ties across slices, NaN and zero directions included."""
    sph, quad = duplicated_rows_scene()
    o, d = random_rays(n, (-8, -8, -8), (8, 8, 8), seed=n)
    d[:: 7] = torch.tensor([0.0, 0.0, 0.0])
    d[3:: 11] = torch.tensor([float("nan"), 0.0, 1.0])
    t_s, p_s = ik.intersect_split_plain(sph, quad, o, d, slice_rows)
    t_p, p_p = ik.intersect_plain(sph, quad, o, d)
    assert torch.equal(t_s.isnan(), t_p.isnan())
    same = ~t_p.isnan()
    assert torch.equal(t_s[same], t_p[same]) and torch.equal(p_s, p_p)


def test_split_plan_fills_the_card():
    """split_rows: launches of at least two blocks an SM keep one pass;
    smaller ones split into slices that start on a sphere group, hold at
    least SPLIT_MIN_ROWS rows and give about SPLIT_TARGET_BLOCKS blocks an
    SM; tables too short to split keep one pass."""
    sms = 132
    assert ik.split_rows(720000, 488, sms) == 0
    assert ik.split_rows(2 * sms * ik.THREADS, 488, sms) == 0
    assert ik.split_rows(0, 488, sms) == 0 and ik.split_rows(100, 60, sms) == 0
    for n in (1, 33, 1000, 28000, (2 * sms - 1) * ik.THREADS):
        rows = ik.split_rows(n, 488, sms)
        slices = -(-488 // rows)
        blocks = -(-n // ik.THREADS)
        assert rows % ik.SPHERE_GROUP == 0 and rows >= ik.SPLIT_MIN_ROWS and slices >= 2
        assert blocks * slices <= ik.SPLIT_TARGET_BLOCKS * sms + blocks * 2


def test_new_wrappers_on_cpu_take_the_twin_and_count_nothing(monkeypatch):
    args, cfg = step_inputs("perlin", 16, "cpu")
    before = (wk.LAUNCHES, ck.LAUNCHES, ik.LAUNCHES_CLUSTERED)
    out = wk.wavefront_step(*args, **cfg)
    ref = wk.wavefront_step_plain(*args, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(out, ref)) and bool(out.grant.all())
    clusters, sph, quad, (o, d), bounces = large_scene_launches(
        "cpu", monkeypatch, width=16, spp=1, n_spheres=200)
    visit = cv.ClusterVisit.build(clusters, sph, quad)
    for fn, (o_, d_) in ((ck.intersect_culled, (o, d)), (ik.intersect_clustered, bounces[0])):
        t, p = fn(clusters, sph, quad, o_, d_)
        t_p, p_p = visit.hit(o_, d_)
        assert torch.equal(t, t_p) and torch.equal(p, p_p)
    assert (wk.LAUNCHES, ck.LAUNCHES, ik.LAUNCHES_CLUSTERED) == before


def test_new_wrappers_reject_bad_inputs(monkeypatch):
    args, cfg = step_inputs("perlin", 16, "cpu")
    with pytest.raises(TypeError, match="active"):
        wk.wavefront_step(*args[:6], args[6].to(torch.int32), *args[7:], **cfg)
    with pytest.raises(ValueError, match="contiguous"):
        wk.wavefront_step(*args[:4], args[4].T.contiguous().T, *args[5:], **cfg)
    clusters, sph, quad, (o, d), _ = large_scene_launches("cpu", monkeypatch, width=8, spp=1,
                                                          n_spheres=50)
    for fn in (ck.intersect_culled, ik.intersect_clustered):
        with pytest.raises(TypeError, match="sph_table"):
            fn(clusters, sph.double(), quad, o, d)
        with pytest.raises(ValueError, match="do not fit"):
            fn(clusters._replace(n_sph=clusters.rows.shape[0] + 1), sph, quad, o, d)
        meta = torch.zeros(4, 3, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fn(clusters._replace(rows=clusters.rows.to("meta")), sph.to("meta"),
               quad.to("meta"), meta, meta)


def test_library_key_follows_sources(tmp_path, monkeypatch):
    """The built library's name hashes every source and the flags, so an
    edit to any .cu/.cuh file selects a new library (a rebuild)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    first = build.library_path()
    assert first.parent == tmp_path / "build" and first.name.startswith("libraytracer_kernels_")
    hdr = csrc / "closest_hit.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert build.library_path() != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert len({first, build.library_path()}) == 2
    flags = " ".join(build.NVCC_FLAGS)
    assert "sm_90a" in flags and "fast_math" not in flags and "--fmad=false" in flags


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_entry_point_signatures_match_the_sources(entry):
    """ctypes passes each entry point exactly the parameters its extern "C"
    definition in csrc/ declares: pointers as c_void_p, ints as c_int,
    floats as c_float, in order (a missing or extra argument shifts every
    later one)."""
    import ctypes
    import re

    sources = "".join(f.read_text() for f in sorted(build.CSRC_DIR.glob("*.cu")))
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", sources, re.S)
    assert m, f"{entry} is not defined in csrc/"
    kinds = []
    for param in m.group(1).split(","):
        words = param.split()
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_float if words[0] == "float" else ctypes.c_int)
    assert kinds == build.SIGNATURES[entry]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library()
