"""The replay kernels of ops/replay_kernel.py: their plain twins against
autograd of the eager replay (integrator/wavefront.py:trace with the tape's
intersect hook, as diff/bucketed.py:replay_loss ran it before), the
dispatch rule, the scratch layout and the counters; `cuda`-marked tests hold
the CUDA kernels against the twins on the card. This file imports no jax, so
on a machine with a card it runs alone:

    python -m pytest --noconftest -o markers="cuda: needs a CUDA device" \\
        -m cuda tests/test_torch_replay_kernel.py
"""

import pytest
import torch

from raytracer_tpu_torch.core.camera import camera_frame, camera_rays, make_camera
from raytracer_tpu_torch.diff import bucketed as bk
from raytracer_tpu_torch.diff.grad import split_scene
from raytracer_tpu_torch.diff.tape import make_tape_intersect_fn
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.integrator.wavefront import trace
from raytracer_tpu_torch.materials.packed import primitive_table, texture_tables
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops import replay_kernel as rk
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils import launches
from raytracer_tpu_torch.utils import trace as tracer

torch.set_num_threads(1)

SEED = 2_400_003_011
WIDTH, SPP, DEPTH = 24, 2, 8
# Every scene field the two tables are built from.
ALL_TABLE_LEAVES = ("sph_center", "sph_radius", "quad_q", "quad_u", "quad_v", "mat_albedo",
                    "mat_fuzz", "mat_ior", "tex_c0", "tex_c1")

# Gradient tolerance, relative to the eager gradient's norm, leaf by leaf:
# the twin sums three-term dot products left to right where the eager code
# calls torch.sum, adds its adjoint terms in its own order and sums the
# lane-bounce rows by primitive in one index_add_ where autograd adds each
# bounce's gather in turn. Those float32 roundings differ by a few ulps, and
# a near-tangent hit (a small discriminant) divides them by its square root:
# the worst reading on these scenes was 4.8e-6 (rand_spheres' mat_fuzz under
# the sky gradient), so 5e-5 leaves a tenfold margin, while a missing or
# wrong derivative term moves a leaf by percents or more.
GRAD_RTOL = 5e-5
# The radiance and the loss: the same arithmetic but for the dot products'
# order (a few ulps of float32).
RADIANCE_RTOL = 1e-5
# The same comparison on the card: there the eager replay's three-term sums
# are CUDA reductions and its table reads sum in the gather kernel's warp
# order, another set of roundings for near-tangent hits to amplify; the
# readings were at most 1.0e-4 (the mixed scene's mat_fuzz under the sky),
# so 1e-3 leaves a margin of ten, still far below what a missing term
# moves. rand_spheres is not compared so on the card: its r = 1000 ground's
# expanded-form sphere test cancels about five digits of float32, so two
# summation orders part by 4e-3-6e-3 in its geometric leaves (ROADMAP,
# Queue 3's caveats); its kernels equal their twins bit for bit below, and
# chip_smoke.py phase 21 holds its gradients by the median row.
CARD_GRAD_RTOL = 1e-3


@pytest.fixture
def recorder():
    tracer.collect()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.collect()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def mixed_scene(sky: bool = False):
    """Every material and branch the adjoint carries: a checkered ground,
    Lambertian spheres, glass and a hollow glass shell (negative radius), a
    fuzz-0 mirror and a fuzzy metal, a light sphere and a light quad, and a
    quad box; a thin-lens camera."""
    b = SceneBuilder(0)
    b.add_sphere((0.0, -100.0, 0.0), 100.0,
                 b.lambertian(b.checker(0.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.add_sphere((-1.2, 0.5, 0.0), 0.5, b.lambertian((0.7, 0.3, 0.2)))
    glass = b.dielectric(1.5)
    b.add_sphere((0.0, 0.5, 0.0), 0.5, glass)
    b.add_sphere((0.0, 0.5, 0.0), -0.4, glass)
    b.add_sphere((1.2, 0.5, 0.0), 0.5, b.metal((0.8, 0.8, 0.9), 0.0))
    b.add_sphere((0.6, 0.25, 1.0), 0.25, b.metal((0.8, 0.6, 0.2), 0.3))
    b.add_sphere((-0.5, 2.0, 0.5), 0.3, b.diffuse_light((4.0, 4.0, 4.0)))
    b.add_box((-0.9, 0.0, 0.8), (-0.4, 0.4, 1.3), b.lambertian((0.3, 0.5, 0.7)))
    b.add_quad((0.5, 1.8, -0.5), (0.6, 0.0, 0.0), (0.0, 0.0, 0.6),
               b.diffuse_light((3.0, 3.0, 3.0)))
    cam, st = make_camera(16.0 / 9.0, WIDTH, samples_per_pixel=SPP, max_depth=DEPTH,
                          look_from=(3.0, 1.5, 4.0), look_at=(0.0, 0.5, 0.0), fov_degrees=45.0,
                          defocus_angle_degrees=0.5, focus_dist=4.5,
                          background=(0.6, 0.7, 0.9), sky_gradient=sky)
    return b.build(), cam, st


def scenes():
    return {"mixed": mixed_scene, "rand_spheres": lambda sky=False: get_scene(
        "rand_spheres", width=WIDTH, spp=SPP, max_depth=DEPTH), "cornell": lambda sky=False:
        get_scene("cornell", width=WIDTH, spp=SPP, max_depth=DEPTH)}


class Replay:
    """A tape forward's replay inputs: the scene's leaves, the tape, the
    lanes, their cotangent and depth bounds, and their first rays."""

    def __init__(self, name, sky, device="cpu"):
        scene, cam, st = scenes()[name](sky)
        self.sky, self.cam = sky, cam
        self.w, self.h = st.width, st.height
        self.params, self.rebuild = split_scene(scene.to(device), ALL_TABLE_LEAVES)
        n = SPP * self.w * self.h
        rad, self.tape = bk.tape_forward(self.params, self.rebuild, None, cam, SEED, n,
                                         width=self.w, height=self.h, max_depth=DEPTH,
                                         sky_gradient=sky, device=device)
        target = torch.full((self.h, self.w, 3), 0.3, device=device)
        _, self.ct, depth, _ = bk.finish(rad, self.tape, target, samples_per_pass=SPP)
        self.lanes = bk.replay_lanes(depth, sky, None)
        self.depth = depth[self.lanes]
        pix = self.lanes % (self.w * self.h)
        frame = camera_frame(cam, self.w, self.h).to(device)
        o, d = camera_rays(frame, pix % self.w, pix // self.w,
                           ctr_rng.camera_uniforms(SEED, self.lanes))
        self.o0, self.d0 = o.detach().contiguous(), d.detach().contiguous()
        self.bg = cam.background.to(device)

    def leaves(self):
        """Fresh leaves: the scene's, o0, d0 and the background."""
        params = {k: v.detach().clone().requires_grad_(True) for k, v in self.params.items()}
        extra = [x.clone().requires_grad_(True) for x in (self.o0, self.d0, self.bg)]
        return params, extra

    def eager(self):
        """(radiance, gradients) of sum(radiance * ct) by the eager replay."""
        params, (o, d, bg) = self.leaves()
        lanes = self.lanes
        rad = trace(self.rebuild(params), o, d, bg,
                    lambda b, idx: ctr_rng.bounce_uniforms(SEED, lanes[idx], b),
                    max_depth=DEPTH, sky_gradient=self.sky,
                    intersect_fn=make_tape_intersect_fn(self.tape[:, lanes]))
        return rad.detach(), self._grads(rad, params, (o, d, bg))

    def kernel_path(self):
        """(radiance, gradients, segments) of the same through ReplayPath."""
        params, (o, d, bg) = self.leaves()
        scene = self.rebuild(params)
        qd = quad_derived(scene)
        rad, segs = rk.replay_path(primitive_table(scene, qd), rk.geom_table(scene, qd), o, d,
                                   bg, self.tape, self.lanes, self.depth, seed=SEED,
                                   ns=scene.num_spheres, sky_gradient=self.sky)
        return rad.detach(), self._grads(rad, params, (o, d, bg)), segs

    def _grads(self, rad, params, extra):
        names = [*params, "o0", "d0", "background"]
        grads = torch.autograd.grad((rad * self.ct[self.lanes]).sum(),
                                    [*params.values(), *extra], allow_unused=True)
        return {k: (torch.zeros_like(x) if g is None else g)
                for k, x, g in zip(names, [*params.values(), *extra], grads)}

    def twin_outputs(self):
        """The twins' forward and adjoint at the unit cotangent's lanes."""
        scene = self.rebuild(self.params)
        qd = quad_derived(scene)
        table = primitive_table(scene, qd).detach()
        geom = rk.geom_table(scene, qd).detach()
        offs, rows = rk.scratch_layout(self.depth)
        args = (table, geom, scene.num_spheres, self.tape, self.lanes, offs, self.depth)
        return args, offs, rows


def relative_gap(a, b):
    return float((a - b).norm() / a.norm().clamp_min(1e-30))


@pytest.mark.parametrize("sky", [False, True], ids=["flat", "sky"])
@pytest.mark.parametrize("name", ["mixed", "rand_spheres", "cornell"])
def test_twin_gradients_equal_eager_autograd(name, sky):
    """The kernel path's loss and its gradient in every table input (through
    the scene fields both tables are built from), in o0, d0 and the flat
    background, against torch.autograd.grad of the eager replay."""
    r = Replay(name, sky)
    rad_e, g_e = r.eager()
    rad_k, g_k, segs = r.kernel_path()
    assert relative_gap(rad_e, rad_k) <= RADIANCE_RTOL
    assert int(segs.max()) <= DEPTH and bool((segs <= r.depth).all())
    moved = 0
    for k in g_e:
        assert bool(torch.isfinite(g_k[k]).all()), k
        if float(g_e[k].norm()) == 0.0:
            assert float(g_k[k].norm()) == 0.0, k
            continue
        moved += 1
        assert relative_gap(g_e[k], g_k[k]) <= GRAD_RTOL, (k, relative_gap(g_e[k], g_k[k]))
    assert moved >= 2


def test_mixed_scene_takes_every_branch():
    """The mixed scene's replay reaches every material, both hit kinds, the
    checker's two colours and both dielectric outcomes, so the gradient
    test above differentiates each branch."""
    r = Replay("mixed", False)
    (table, geom, ns, tape, lanes, offs, depth), _, rows = r.twin_outputs()
    fwd = rk.replay_forward_plain(table, geom, ns, tape, lanes, offs, depth, rows, r.o0, r.d0,
                                  r.bg, SEED, False)
    seen = {"quad": False, "sphere": False, "c1": False, "reflect": False, "refract": False}
    mtypes = set()
    for b in range(DEPTH):
        act = torch.nonzero(fwd.segments > b).flatten()
        st = fwd.state[offs[act] + b]
        f = rk._forward_bounce(table, geom, ns, tape[b, lanes[act]],
                               rk._vec(st[:, 0:3]), rk._vec(st[:, 3:6]),
                               ctr_rng.bounce_uniforms(SEED, lanes[act], b))
        h = f.hit
        mtypes |= set(f.mtype[h].tolist())
        seen["quad"] |= bool((h & f.quad).any())
        seen["sphere"] |= bool((h & ~f.quad).any())
        seen["c1"] |= bool((h & f.use_c1).any())
        seen["reflect"] |= bool((h & f.diel & f.use_reflect).any())
        seen["refract"] |= bool((h & f.diel & ~f.use_reflect).any())
    assert mtypes == {0, 1, 2, 3} and all(seen.values()), (mtypes, seen)


def test_trainable_camera_step_equals_eager(monkeypatch):
    """A bucketed step with a trainable camera: the kernel branch of
    replay_loss (its twins on the CPU) against the eager branch, the camera
    leaves' gradients reaching them through o0 and d0."""
    scene, cam, st = mixed_scene()
    target = torch.full((st.height, st.width, 3), 0.4)
    grads = {}
    for branch in ("eager", "kernel"):
        if branch == "kernel":
            monkeypatch.setattr(bk, "takes_replay_kernel",
                                lambda sc, dev: rk.replay_kernel_reason(sc) is None)
        params, rebuild = split_scene(scene)
        cparams, rebuild_camera = bk.split_camera(cam, ("look_from", "look_at", "fov_radians",
                                                        "background"))
        params[bk.CAMERA_PARAM_KEY] = cparams
        step = bk.make_bucketed_grad_fn(rebuild, cam, target, width=st.width, height=st.height,
                                        samples_per_pass=SPP, max_depth=DEPTH,
                                        rebuild_camera=rebuild_camera)
        loss, g = step(params, 5)
        grads[branch] = (float(loss), dict(bk.flat_leaves(g)))
    (loss_e, g_e), (loss_k, g_k) = grads["eager"], grads["kernel"]
    assert loss_e == loss_k
    for k in g_e:
        if float(g_e[k].norm()) == 0.0:
            assert float(g_k[k].norm()) == 0.0, k
        else:
            assert relative_gap(g_e[k], g_k[k]) <= GRAD_RTOL, (k, relative_gap(g_e[k], g_k[k]))
    assert float(g_e[("camera", "look_from")].norm()) > 0.0


@pytest.mark.parametrize("name, takes", [
    ("rand_spheres", True), ("cornell", True), ("quads", True), ("one_weekend_final", True),
    ("perlin", False), ("earth", False), ("simple_light", False)])
def test_dispatch_reason(name, takes):
    """The kernels take every scene without noise or image textures (no
    texture table), on CUDA tensors only; the rest keep the eager replay."""
    scene = get_scene(name, width=8, spp=1, max_depth=2)[0]
    assert (rk.replay_kernel_reason(scene) is None) == takes
    assert (texture_tables(scene, quad_derived(scene)) is None) == takes
    assert bk.takes_replay_kernel(scene, "cuda") == takes
    assert not bk.takes_replay_kernel(scene, "cpu")


def test_scratch_layout():
    """Each lane owns `depth` consecutive rows, in lane order."""
    depth = torch.tensor([1, 3, 2, 5, 1], dtype=torch.int32)
    offs, rows = rk.scratch_layout(depth)
    assert offs.dtype == torch.int64 and offs.tolist() == [0, 1, 4, 6, 11] and rows == 12
    offs, rows = rk.scratch_layout(torch.zeros(0, dtype=torch.int32))
    assert offs.numel() == 0 and rows == 0


@pytest.mark.parametrize("sky", [False, True], ids=["flat", "sky"])
def test_twin_fills_its_layout(sky):
    """The forward writes a lane's state rows [offs, offs + segments) and
    no others; segments never pass the depth bound; the adjoint's rows past
    a lane's segments, and its miss rows, are zero rows of index 0; each
    lane's first state row is its first ray with unit throughput."""
    r = Replay("mixed", sky)
    args, offs, rows = r.twin_outputs()
    fwd = rk.replay_forward(*args, rows, r.o0, r.d0, r.bg, SEED, sky)
    assert fwd.state.shape == (rows, rk.STATE_COLS) and bool((fwd.segments >= 1).all())
    assert bool((fwd.segments <= r.depth).all())
    owner = torch.repeat_interleave(torch.arange(r.lanes.shape[0]), r.depth.long())
    slot = torch.arange(rows) - offs[owner]
    used = slot < fwd.segments[owner].long()
    assert bool((fwd.state[~used] == 0).all())
    first = fwd.state[offs]
    assert torch.equal(first[:, 0:3], r.o0) and torch.equal(first[:, 3:6], r.d0)
    assert bool((first[:, 6:9] == 1.0).all())
    grad = r.ct[r.lanes]
    adj = rk.replay_adjoint(*args, fwd, grad, r.bg, SEED, sky)
    assert adj.rows.shape == (rows, rk.ROW_COLS) and adj.index.dtype == torch.int32
    assert bool((adj.rows[~used] == 0).all()) and bool((adj.index[~used] == 0).all())
    assert bool((adj.rows[:, 4] == 0).all())  # the material type takes no gradient
    assert adj.lane.shape == (r.lanes.shape[0], rk.LANE_COLS)
    if sky:
        assert bool((adj.lane[:, 6:9] == 0).all())


def test_reduce_rows_splits_the_tables():
    """The rows sum by primitive into the table's gradient (its columns with
    no gradient zeroed) and the intersection table's (columns 12-15)."""
    g = torch.Generator().manual_seed(3)
    rows = torch.randn(50, rk.ROW_COLS, generator=g)
    index = torch.randint(0, 7, (50,), generator=g, dtype=torch.int32)
    adj = rk.ReplayAdjoint(rows, index, torch.zeros(0, rk.LANE_COLS))
    g_table, g_geom = rk.reduce_rows(adj, 7)
    want = torch.zeros(7, rk.ROW_COLS, dtype=torch.float64).index_add_(
        0, index.long(), rows.double())
    assert torch.allclose(g_geom.double(), want[:, 12:16], rtol=1e-6, atol=1e-6)
    keep = [c for c in range(rk.ROW_COLS) if c not in rk.TABLE_NO_GRAD_COLS]
    assert torch.allclose(g_table[:, keep].double(), want[:, keep], rtol=1e-6, atol=1e-6)
    assert bool((g_table[:, list(rk.TABLE_NO_GRAD_COLS)] == 0).all())


def test_twins_launch_nothing():
    """CPU calls take the twins and count no launch."""
    launches.reset()
    r = Replay("rand_spheres", False)
    r.kernel_path()
    counts = launches.read()
    assert counts["replay_path"] == 0 and counts["replay_adjoint"] == 0


def test_counters_on_a_traced_cpu_step(recorder, monkeypatch):
    """A traced bucketed step counts `replays_eager` on the CPU; with the
    kernel branch taken (its twins), `replays_kernel` and the traced
    lane-bounces `replay_kernel_segments` instead, under `replay_forward`
    and the root `step`'s phases."""
    scene, cam, st = get_scene("rand_spheres", width=16, spp=2, max_depth=4)
    target = torch.full((st.height, st.width, 3), 0.5)
    kw = dict(width=st.width, height=st.height, samples_per_pass=2, max_depth=4)
    counts = {}
    for branch in ("eager", "kernel"):
        if branch == "kernel":
            monkeypatch.setattr(bk, "takes_replay_kernel",
                                lambda sc, dev: rk.replay_kernel_reason(sc) is None)
        params, rebuild = split_scene(scene)
        tracer.collect()
        with tracer.span("step"):
            bk.make_bucketed_grad_fn(rebuild, cam, target, **kw)(params, 9)
        spans = tracer.collect()
        counts[branch] = {s["name"]: s["counts"] for s in spans}
    eager, kernel = counts["eager"], counts["kernel"]
    assert eager["replay_forward"]["replays_eager"] == 1
    assert "replays_kernel" not in eager["step"] and eager["step"]["replays_eager"] == 1
    assert kernel["replay_forward"]["replays_kernel"] == 1
    assert "replays_eager" not in kernel["step"]
    segments = kernel["replay_forward"]["replay_kernel_segments"]
    assert segments == kernel["step"]["replay_kernel_segments"]
    assert segments == eager["replay_forward"]["lanes"]  # the eager replay's lane-bounces
    assert "bounces" not in kernel["replay_forward"]


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [False, True], ids=["flat", "sky"])
@pytest.mark.parametrize("name", ["mixed", "rand_spheres", "cornell"])
def test_kernels_equal_their_twins(cuda, name, sky):
    """The forward (radiance, state, segments) and the adjoint (rows, index,
    per-lane cotangents) of the CUDA kernels equal the twins' run on the
    card bit for bit, and two launches are bit-identical."""
    r = Replay(name, sky, device=cuda)
    args, offs, rows = r.twin_outputs()
    fwd = rk.replay_forward(*args, rows, r.o0, r.d0, r.bg, SEED, sky)
    fwd_p = rk.replay_forward_plain(*args, rows, r.o0, r.d0, r.bg, SEED, sky)
    for a, b in zip(fwd, fwd_p):
        assert torch.equal(a, b)
    grad = r.ct[r.lanes].contiguous()
    adj = rk.replay_adjoint(*args, fwd, grad, r.bg, SEED, sky)
    adj_p = rk.replay_adjoint_plain(*args, fwd_p, grad, r.bg, SEED, sky)
    for a, b in zip(adj, adj_p):
        assert torch.equal(a, b)
    again = rk.replay_adjoint(*args, fwd, grad, r.bg, SEED, sky)
    assert all(torch.equal(a, b) for a, b in zip(adj, again))


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [False, True], ids=["flat", "sky"])
@pytest.mark.parametrize("name", ["mixed", "cornell"])
def test_kernel_path_gradients_on_the_card(cuda, name, sky):
    """ReplayPath's gradients on the card against autograd of the eager
    replay on the card."""
    r = Replay(name, sky, device=cuda)
    rad_e, g_e = r.eager()
    rad_k, g_k, _ = r.kernel_path()
    assert relative_gap(rad_e, rad_k) <= RADIANCE_RTOL
    gaps = {k: relative_gap(g_e[k], g_k[k]) for k in g_e if float(g_e[k].norm()) > 0.0}
    print(f"{name} {'sky' if sky else 'flat'} gradient gaps {gaps}")
    assert all(v <= CARD_GRAD_RTOL for v in gaps.values()), gaps
