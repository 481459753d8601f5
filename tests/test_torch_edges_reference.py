"""The port's edge terms against the benchmark's plain reference of them
(benchmark/reference/edges.py, float64), on the CPU at a small size: a
ground sphere and four spheres, one of each material, at 24x16, 2 spp,
depth 4. The port's primary-silhouette and shadow-edge gradients equal the
reference's sample for sample at the exhaustive and the reduced budgets;
the reference's own gradient, interior plus edges, agrees with a central
finite difference of its own loss; follow_edges follows the port's
bucketed step for two steps within the edge cell's limits; and each
planted fault and the bfloat16 control fail those limits."""

import math

import pytest
import torch

from benchmark import harness, scenes
from benchmark.jobs import train_edges
from benchmark.reference import edges, tracer
from benchmark.reference import train as reference
from raytracer_tpu_torch.diff.boundary import EdgeSamplingConfig, make_boundary_image_fn
from raytracer_tpu_torch.diff.bucketed import compose_edges
from raytracer_tpu_torch.diff.grad import make_inverse_renderer, split_scene
from raytracer_tpu_torch.diff.shadow_edge import ShadowEdgeConfig, make_shadow_boundary_fn

SCENE = {"spheres": [
    {"center": [0, -1000, 0], "radius": 1000,
     "material": {"lambertian": {"checker": {"scale": 0.32, "even": [0.2, 0.3, 0.1],
                                             "odd": [0.9, 0.9, 0.9]}}}},
    {"center": [0, 1, 0], "radius": 1, "material": {"lambertian": [0.4, 0.2, 0.1]}},
    {"center": [-2.2, 0.7, 0.8], "radius": 0.7,
     "material": {"metal": {"albedo": [0.7, 0.6, 0.5], "fuzz": 0.2}}},
    {"center": [2.0, 0.6, -0.5], "radius": 0.6, "material": {"dielectric": {"ior": 1.5}}},
    {"center": [0.8, 2.6, 1.5], "radius": 0.4, "material": {"light": [4.0, 4.0, 4.0]}}]}
CAMERA = {"aspect": 1.5, "width": 24, "look_from": [9, 2.5, 5], "look_at": [0, 0.8, 0],
          "vup": [0, 1, 0], "fov_degrees": 30, "defocus_angle_degrees": 0.6, "focus_dist": 10,
          "background": [0.7, 0.8, 1.0], "sky_gradient": False}
SPP, DEPTH, LR = 2, 4, 0.01
GEOMETRY = ("sph_center", "sph_radius")
LIMITS = harness.Cell.load("rand_spheres.train_edges").check["limits"]
REDUCED = ((EdgeSamplingConfig(samples_per_sphere=64, samples_per_quad_edge=32, spp_edge=4),
            ShadowEdgeConfig(receivers=64, sources_per_receiver=2, samples_per_sphere=16)),
           (edges.Boundary(64, 4), edges.Shadow(16, receivers=64, sources=2)))
EXHAUSTIVE = ((EdgeSamplingConfig(), ShadowEdgeConfig()), (edges.Boundary(), edges.Shadow()))

torch.set_num_threads(4)


def fails(reading: dict) -> bool:
    return any(not math.isfinite(reading[k]) or reading[k] > v for k, v in LIMITS.items())


@pytest.fixture(scope="module")
def setup():
    desc = scenes.describe(SCENE)
    w, h = scenes.image_size(CAMERA)
    sc = tracer.scene_from_description(desc, "cpu")
    perturb = {"color": 0.3, "fuzz": 0.1, "center": 0.05, "radius": 0.03}
    from benchmark.jobs.train import perturbed

    target = reference.image(perturbed(sc, 7, perturb), CAMERA, 3, spp=SPP, max_depth=DEPTH)
    return desc, w, h, sc, target


@pytest.mark.parametrize("budget,seeds", [(EXHAUSTIVE, (11,)), (REDUCED, (11, 2**31 + 3))],
                         ids=["exhaustive", "reduced"])
def test_port_terms_are_the_references(setup, budget, seeds):
    desc, w, h, _, _ = setup
    (b_cfg, s_cfg), ref_budget = budget
    cam, _ = harness.port_camera(CAMERA, SPP, DEPTH)
    params, rebuild = split_scene(harness.port_scene(desc), GEOMETRY)
    kw = dict(width=w, height=h, max_depth=DEPTH)
    fns = [make_boundary_image_fn(rebuild, config=b_cfg, **kw),
           make_shadow_boundary_fn(rebuild, config=s_cfg, **kw)]
    ct = torch.randn(h, w, 3, generator=torch.Generator().manual_seed(5)) * 0.01
    sc64 = tracer.scene_from_description(desc, "cpu", torch.float64)
    for seed in seeds:
        ref, = edges.edge_terms(sc64, GEOMETRY, CAMERA, seed, [ct], max_depth=DEPTH,
                                budget=ref_budget)
        for i, name in enumerate(train_edges.TERMS):
            alone = [fns[j] if j == i else
                     (lambda p, c, s: torch.zeros(h, w, 3) + 0.0 * p["sph_center"].sum())
                     for j in range(i + 1)]
            got = compose_edges(alone, params, cam, seed, ct)
            for k in GEOMETRY:
                assert float(ref[name][k].norm()) > 0
                # The port traces in float32 (each small sphere's hit by the
                # stable quadratic), the reference in float64: a few deep
                # paths part on rounding (rows <= 0.0022, norms <= 0.0015
                # here).
                rows = train_edges.terms_gap([{name: got}], [ref], [k], [name])[name]
                assert rows < 0.01, (name, k, rows)
                gap = float((got[k].double() - ref[name][k]).norm() / ref[name][k].norm())
                assert gap < 0.005, (name, k, gap)


def test_reference_gradient_is_the_finite_difference(setup):
    """The reference's own full gradient (interior plus both edge terms) of a
    fixed weighting of its image, J = sum(w * image), against a central
    finite difference of J under the same samples, each the mean over three
    seeds: within 20% for the light sphere's height and radius (a term of
    the primary silhouettes alone: no interior gradient reaches an
    emitter's geometry) and the diffuse sphere's x, where the interior
    alone misses by more than that. (Edges seen in the metal and glass
    spheres, and shadow edges past the first bounce, are not sampled: the
    diffuse sphere's radius, which those spheres show, reads 30% off.)"""
    desc, w, h, _, _ = setup
    sc = tracer.scene_from_description(desc, "cpu", torch.float64)
    weight = torch.randn(h, w, 3, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    spp, step = 256, 0.075
    checks = (("sph_center", (4, 1)), ("sph_radius", (4,)), ("sph_center", (1, 0)))
    full, interior_only, fd = ([0.0] * len(checks) for _ in range(3))
    for seed in (21, 22, 23):
        img = reference.image(sc, CAMERA, seed, spp=spp, max_depth=DEPTH)
        # The MSE's cotangent 2 (image - target) / n is the weight at this target.
        target = img - weight * (img.numel() / 2.0)
        leaves = {k: getattr(sc, k).clone().requires_grad_(True) for k in GEOMETRY}
        _, interior = reference.loss_and_grad(sc, leaves, CAMERA, target, seed, spp=spp,
                                              max_depth=DEPTH)
        terms, = edges.edge_terms(sc, GEOMETRY, CAMERA, seed, [weight], max_depth=DEPTH,
                                  budget=EXHAUSTIVE[1])
        for i, (leaf, index) in enumerate(checks):
            interior_only[i] += float(interior[leaf][index]) / 3
            full[i] += float(interior[leaf][index] + terms["boundary"][leaf][index]
                             + terms["shadow"][leaf][index]) / 3

            def j_at(dx):
                v = getattr(sc, leaf).clone()
                v[index] += dx
                moved = reference.image(sc.replace(**{leaf: v}), CAMERA, seed, spp=spp,
                                        max_depth=DEPTH)
                return float((moved * weight).sum())

            fd[i] += (j_at(step) - j_at(-step)) / (2 * step) / 3
    for i, (leaf, index) in enumerate(checks):
        assert abs(full[i] - fd[i]) < 0.2 * abs(fd[i]), (leaf, index, full[i], fd[i])
    assert abs(interior_only[2] - fd[2]) > 0.2 * abs(fd[2]), (interior_only[2], fd[2])


def port_run(desc, w, h, target, seeds):
    """Two bucketed steps of the port with both edge terms: the job's
    record of them (losses, start, states, terms) and the cotangents."""
    cam, _ = harness.port_camera(CAMERA, SPP, DEPTH)
    scene = harness.port_scene(desc)
    params, optimizer, step = make_inverse_renderer(
        scene, cam, target, width=w, height=h, samples_per_pass=SPP, max_depth=DEPTH,
        learning_rate=LR, boundary=True, shadow_edges=True, backend="bucketed", device="cpu")
    program = {"losses": [], "start": {k: p.detach().clone() for k, p in params.items()},
               "states": []}
    for seed in seeds:
        program["losses"].append(float(step(seed)))
        program["states"].append(
            {"params": {k: p.detach().clone() for k, p in params.items()},
             **{m: {k: optimizer.state[p][m].clone() for k, p in params.items()}
                for m in ("exp_avg", "exp_avg_sq")}})
    before = [program["start"]] + [s["params"] for s in program["states"][:-1]]
    program["terms"], cts = train_edges.program_terms(
        scene, cam, target, before, seeds, trainable=tuple(params), width=w, height=h, spp=SPP,
        max_depth=DEPTH, sky_gradient=False)
    return program, cts


def test_follow_edges_follows_the_port(setup):
    desc, w, h, sc, target = setup
    seeds = [5, 2**31 + 17]
    program, cts = port_run(desc, w, h, target, seeds)
    ref = edges.follow_edges(sc, CAMERA, target, seeds, spp=SPP, max_depth=DEPTH, lr=LR,
                             states=program["states"], cts=cts)
    got = train_edges.numbers(program, ref, LR)
    assert not fails(got), got
    assert got["loss_gap"] < 1e-5 and got["update_gap"] < 1e-5


@pytest.mark.parametrize("variant", ("bf16",) + edges.FAULTS)
def test_control_and_faults_fail(setup, variant):
    _, _, _, sc, target = setup
    kw = dict(spp=SPP, max_depth=DEPTH, lr=LR, budget=REDUCED[1])
    seeds = [9]
    if variant == "bf16":
        other = edges.follow_edges(edges.cast(sc, torch.bfloat16), CAMERA, target, seeds,
                                   edge_dtype=torch.bfloat16, **kw)
    else:
        other = edges.follow_edges(sc, CAMERA, target, seeds, fault=variant, **kw)
    ref = edges.follow_edges(sc, CAMERA, target, seeds, states=other["states"],
                             cts=other["cts"], **kw)
    reading = train_edges.numbers(other, ref, LR)
    assert fails(reading), reading
