"""The edge path kernel (ops/edge_path_kernel.py, csrc/edge_path_kernel.cu):
the dispatch of diff/boundary.py:trace_edge_rays, the wrapper's refusals,
the counters and the benchmark's reader of its roofline share on the CPU;
`cuda`-marked tests hold the kernel against its plain twin, the eager
integrator/wavefront.py:trace, bit for bit on the card, and count its
launches, syncs and lane-bounces there. This file imports no jax, so on a
machine with a card it runs alone:

    python -m pytest --noconftest -o markers="cuda: needs a CUDA device" \\
        -m cuda tests/test_torch_edge_path_kernel.py
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import camera_frame
from raytracer_tpu_torch.diff import boundary
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.integrator.wavefront import trace
from raytracer_tpu_torch.materials.packed import FILTER_STOCHASTIC, texture_tables
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops import edge_path_kernel as ek
from raytracer_tpu_torch.ops import persistent_kernel as pk
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils import launches
from raytracer_tpu_torch.utils import trace as tracer

torch.set_num_threads(1)

SEED = 2_700_001_029
# Scene boxes that random rays start in (rand_spheres', cornell's).
BOXES = {"rand_spheres": ((-12, 0.05, -12), (12, 6, 12)), "cornell": ((1, 1, 1), (554, 554, 554)),
         "perlin": ((-4, 0.1, -4), (4, 4, 4)), "earth": ((-4, -4, 4), (4, 4, 14))}


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


def edge_rays(name, k, device, *, width=64, live_share=1.0, seed=5, **scene_kw):
    """(scene, origin, direction, background, live) on `device`: half the K
    rays from the camera through random continuous pixel coordinates, as the
    silhouette term traces them, half from random points of the scene's box
    in random directions, as the shadow term's receivers send them; `live`
    False on about 1 - live_share of them (None for a share of 1)."""
    scene, cam, st = get_scene(name, width=width, spp=2, max_depth=8, **scene_kw)
    frame = camera_frame(cam, st.width, st.height)
    rng = np.random.default_rng(seed)
    kc = k // 2
    px = torch.from_numpy(rng.uniform(0, 1, (kc, 2)).astype(np.float32)) \
        * torch.tensor([st.width, st.height], dtype=torch.float32) - 0.5
    target = frame.pixel00 + px[:, 0:1] * frame.pixel_du + px[:, 1:2] * frame.pixel_dv
    o_cam = frame.center.expand_as(target)
    lo, hi = BOXES[name]
    o_box = torch.from_numpy(rng.uniform(lo, hi, (k - kc, 3)).astype(np.float32))
    d_box = torch.from_numpy(rng.normal(size=(k - kc, 3)).astype(np.float32))
    origin = torch.cat([o_cam, o_box]).contiguous()
    direction = torch.cat([target - o_cam, d_box]).contiguous()
    live = None
    if live_share < 1.0:
        live = torch.from_numpy(rng.uniform(0, 1, k) < live_share).to(device)
    return (scene.to(device), origin.to(device), direction.to(device),
            cam.background.to(torch.float32).to(device), live)


def eager(scene, origin, direction, background, seed, *, spp_edge, max_depth, sky_gradient,
          live=None):
    """trace_edge_rays' eager twin, lane by lane: (K x spp_edge, 3)."""
    return trace(
        scene, origin.repeat(spp_edge, 1), direction.repeat(spp_edge, 1), background,
        lambda bounce, lanes: ctr_rng.bounce_uniforms(seed, lanes, bounce),
        max_depth=max_depth, sky_gradient=sky_gradient, russian_roulette=True, rr_max_q=0.75,
        rr_uniform=lambda bounce, lanes: ctr_rng.rr_uniforms(seed, lanes, bounce, max_depth),
        stable_spheres=True, live=None if live is None else live.repeat(spp_edge))


def report(a, b):
    return (f"equal on {float((a == b).all(dim=-1).float().mean()):.6f} of lanes, max |diff| "
            f"{float((a.double() - b.double()).abs().max()):.3g}")


# ---- the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("name,max_depth,sky,spp_edge,live_share", [
    ("rand_spheres", 50, False, 4, 1.0),  # spheres, checker ground, metal, glass
    ("rand_spheres", 49, False, 2, 0.4),  # the shadow term's depth, invalid points
    ("rand_spheres", 50, True, 2, 0.6),
    ("cornell", 50, False, 4, 1.0),  # quads and an emitter
    ("cornell", 50, True, 2, 0.4),
    ("perlin", 50, True, 2, 0.7),  # the procedural marble
    ("earth", 20, False, 4, 0.7),  # an image texture
])
def test_kernel_equals_the_eager_trace_on_live_lanes(cuda, name, max_depth, sky, spp_edge,
                                                      live_share):
    """Every live lane's radiance bit-equal to the eager trace's with the same
    arguments; lanes of rays False in `live` read zeros."""
    scene, o, d, bg, live = edge_rays(name, 4096, cuda, live_share=live_share)
    kw = dict(spp_edge=spp_edge, max_depth=max_depth, sky_gradient=sky)
    rad_k, segs = ek.edge_path_scene(scene, o, d, bg, SEED, live=live, count_segments=True,
                                     **kw)
    rad_e = eager(scene, o, d, bg, SEED, live=live, **kw)
    torch.cuda.synchronize()
    on = torch.ones(o.shape[0] * spp_edge, dtype=torch.bool, device=cuda) if live is None \
        else live.repeat(spp_edge)
    assert torch.equal(rad_k[on], rad_e[on]), report(rad_k[on], rad_e[on])
    assert not bool(rad_k[~on].any())
    assert int(segs) >= int(on.sum())


@pytest.mark.cuda
def test_one_launch_and_no_sync_a_call(cuda):
    """trace_edge_rays on the card: one edge-path launch and no kernel-1 one,
    no host sync under PyTorch's sync debug mode, and the mean over spp_edge
    of the eager trace on the live rays."""
    scene, o, d, bg, live = edge_rays("rand_spheres", 2048, cuda, live_share=0.5)
    kw = dict(background=bg, max_depth=50, sky_gradient=False, spp_edge=4, live=live)
    boundary.trace_edge_rays(scene, o, d, SEED, **kw)  # builds and loads the library
    torch.cuda.synchronize()
    launches.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = boundary.trace_edge_rays(scene, o, d, SEED, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = launches.read()
    assert counts["edge_path"] == 1 and counts["closest_hit"] == 0
    want = eager(scene, o, d, bg, SEED, spp_edge=4, max_depth=50, sky_gradient=False,
                 live=live).reshape(4, o.shape[0], 3).mean(dim=0)
    assert torch.equal(out[live], want[live])


@pytest.mark.cuda
def test_kernel_counters_on_the_card(cuda, recorder):
    """On the card a call counts `edge_traces_kernel` and the kernel's
    lane-bounces as `edge_path_segments`, which equal the eager trace's
    `lanes` over the same rays (every ray live), while `lanes` and
    `bounces` under the span stay 0."""
    scene, o, d, bg, _ = edge_rays("rand_spheres", 2048, cuda)
    kw = dict(background=bg, max_depth=50, sky_gradient=False, spp_edge=2)
    with tracer.span("edges/boundary/trace"):
        boundary.trace_edge_rays(scene, o, d, SEED, **kw)
    with tracer.span("eager"):
        eager(scene, o, d, bg, SEED, spp_edge=2, max_depth=50, sky_gradient=False)
    spans = {s["name"]: s["counts"] for s in recorder.collect()}
    mine, twin = spans["edges/boundary/trace"], spans["eager"]
    assert mine["edge_traces_kernel"] == 1 and "edge_traces_eager" not in mine
    assert mine.get("lanes", 0) == 0 and mine.get("bounces", 0) == 0
    assert mine["edge_path_segments"] == twin["lanes"] > 0


# ---- the CPU ----


def test_cpu_rays_take_the_eager_trace(recorder):
    """CPU tensors take the eager trace: `edge_traces_eager` and its `lanes`
    counted, no launch, the mean of the twin's lanes."""
    scene, o, d, bg, live = edge_rays("rand_spheres", 64, "cpu", width=16, live_share=0.7)
    before = ek.LAUNCHES
    with tracer.span("edges/boundary/trace"):
        out = boundary.trace_edge_rays(scene, o, d, SEED, background=bg, max_depth=8,
                                       sky_gradient=False, spp_edge=2, live=live)
    counts = recorder.collect()[-1]["counts"]
    assert counts["edge_traces_eager"] == 1 and "edge_traces_kernel" not in counts
    assert counts["lanes"] > 0 and "edge_path_segments" not in counts
    assert ek.LAUNCHES == before
    want = eager(scene, o, d, bg, SEED, spp_edge=2, max_depth=8, sky_gradient=False,
                 live=live).reshape(2, 64, 3).mean(dim=0)
    assert torch.equal(out, want)


@pytest.mark.parametrize("name,kw,device,takes", [
    ("rand_spheres", {}, "cuda", True),
    ("cornell", {}, "cuda:0", True),
    ("perlin", {}, "cuda", True),  # procedural Perlin tables
    ("earth", {}, "cuda", True),
    ("perlin", {"procedural_perlin": False}, "cuda", False),  # rng-filled tables
    ("rand_spheres", {}, "cpu", False),
])
def test_dispatch_by_device_and_scene(name, kw, device, takes):
    """The kernel takes CUDA tensors of every scene kernel 2 shades; CPU
    tensors and rng-filled Perlin tables keep the eager trace."""
    scene, _, _ = get_scene(name, width=16, spp=2, max_depth=4, **kw)
    assert ek.takes_edge_path_kernel(scene, device) is takes
    assert (pk.unsupported_reason(scene) is None) is (takes or device == "cpu")


def test_scene_tables_pack_once_a_scene():
    """scene_tables packs trace's tables, and returns the last scene's from
    its cache while that scene's tensors are unchanged: an edited tensor, a
    replaced one or another scene packs anew; a scene with a tensor that
    requires grad is never cached."""
    import dataclasses

    from raytracer_tpu_torch.materials.packed import primitive_table
    from raytracer_tpu_torch.ops.intersect_kernel import pack_sphere_table

    scene, _, _ = get_scene("rand_spheres", width=16, spp=2, max_depth=4)
    first = ek.scene_tables(scene)
    assert torch.equal(first[0], pack_sphere_table(scene.sph_center, scene.sph_radius))
    assert torch.equal(first[2], primitive_table(scene, quad_derived(scene)))
    assert ek.scene_tables(scene) is first
    scene.sph_radius.mul_(1.0)  # an in-place edit bumps the version
    second = ek.scene_tables(scene)
    assert second is not first and ek.scene_tables(scene) is second
    moved = dataclasses.replace(scene, sph_center=scene.sph_center + 1.0)
    third = ek.scene_tables(moved)
    assert third is not second and not torch.equal(third[0], second[0])
    grad = dataclasses.replace(scene, tex_c0=scene.tex_c0.clone().requires_grad_(True))
    assert ek.scene_tables(grad) is not ek.scene_tables(grad)


def wrapper_args(name="rand_spheres", k=8):
    """edge_path's arguments (CPU tensors) for `name`, as a dict."""
    scene, o, d, bg, _ = edge_rays(name, k, "cpu", width=16)
    from raytracer_tpu_torch.ops.intersect_kernel import pack_quad_table, pack_sphere_table
    from raytracer_tpu_torch.materials.packed import primitive_table

    qd = quad_derived(scene)
    return dict(sph_table=pack_sphere_table(scene.sph_center, scene.sph_radius),
                quad_table=pack_quad_table(qd), res_table=primitive_table(scene, qd),
                radius=scene.sph_radius.contiguous(), origin=o, direction=d, background=bg,
                seed=SEED, spp_edge=2, max_depth=8, textures=texture_tables(scene, qd))


def _stochastic(a):
    a = wrapper_args("earth")
    a["textures"] = a["textures"]._replace(image_filter=FILTER_STOCHASTIC)
    return a


def _rng_perlin(a):
    scene, _, _ = get_scene("perlin", width=16, spp=2, max_depth=4, procedural_perlin=False)
    a = wrapper_args("perlin")
    a["textures"] = texture_tables(scene, quad_derived(scene))
    return a


@pytest.mark.parametrize("change,error,match", [
    (lambda a: a, ValueError, "CUDA tensors"),  # well-formed CPU tensors
    (lambda a: dict(a, origin=a["origin"].double()), TypeError, "origin"),
    (lambda a: dict(a, direction=a["direction"][:-1]), ValueError, "direction"),
    (lambda a: dict(a, origin=a["origin"][:, :2].contiguous()), ValueError, "origin"),
    (lambda a: dict(a, radius=a["radius"][:-1]), ValueError, "radius"),
    (lambda a: dict(a, res_table=a["res_table"][:, :12].contiguous()), ValueError, "res_table"),
    (lambda a: dict(a, background=a["background"].double()), TypeError, "background"),
    (lambda a: dict(a, live=torch.ones(a["origin"].shape[0], dtype=torch.uint8)), TypeError,
     "live"),
    (lambda a: dict(a, live=torch.ones(3, dtype=torch.bool)), ValueError, "live"),
    (lambda a: dict(a, direction=a["direction"].t().contiguous().t()), ValueError,
     "contiguous"),
    (lambda a: dict(a, spp_edge=0), ValueError, "spp_edge"),
    (lambda a: dict(a, max_depth=0), ValueError, "max_depth"),
    (_stochastic, ValueError, "deterministic image filter"),
    (_rng_perlin, ValueError, "procedural Perlin"),
])
def test_wrapper_refuses_what_it_cannot_take(change, error, match):
    """edge_path raises, before any launch, on CPU tensors and on inputs of
    the wrong dtype, shape, layout or settings."""
    before = ek.LAUNCHES
    with pytest.raises(error, match=match):
        ek.edge_path(**change(wrapper_args()))
    assert ek.LAUNCHES == before


def roofline_record(kernel_us, segments, items=2, spheres=488, quads=0):
    """A traced run's record as benchmark/profiling.py and spans.py leave it:
    `items` steps, the kernel's device operations of kernel_us microseconds
    in all, `segments` lane-bounces counted under the edge traces' spans."""
    from benchmark.profiling import TraceRecord

    ops = [("void (anonymous namespace)::edge_path_kernel<0>(float4 const*, ...)", 0.0,
            kernel_us)] if kernel_us else []
    ops.append(("void (anonymous namespace)::intersect_kernel(...)", 0.0, 10.0))
    by_name = {"edges/boundary/trace": {"n": 6},
               "edges/shadow/trace": {"n": 6}}
    if segments:
        by_name["edges/boundary/trace"]["edge_path_segments"] = segments // 2
        by_name["edges/shadow/trace"]["edge_path_segments"] = segments - segments // 2
    return TraceRecord(device_ops=ops, spans_s=[1.0] * items,
                       extra={"spans": {"items": items, "cuda": True, "by_name": by_name},
                              "spheres": spheres, "quads": quads})


def test_edge_path_roofline_reads_the_kernel_and_its_segments():
    """edge_path_roofline_pct.edges: the hit work of the counted lane-bounces
    at the FP32 peak over the kernel's device time a step; None without the
    kernel's operations or without its counter (a program that traces the
    edges otherwise)."""
    from benchmark import peaks
    from benchmark.run import metric_reader

    read = metric_reader("edge_path_roofline_pct.edges")
    segs, us, items = 3_260_000, 4_000.0, 2
    want = 100.0 * (segs / items) * (488 * peaks.SPHERE_OPS + peaks.RAY_OPS) / peaks.PEAK_FP32 \
        / (us / 1e6 / items)
    assert read(roofline_record(us, segs, items)) == pytest.approx(want, rel=1e-12)
    assert 0.0 < want < 100.0
    assert read(roofline_record(None, segs)) is None
    assert read(roofline_record(us, 0)) is None
