"""Train job: inverse rendering, one step after another. Set-up makes the
target, the reference's render of the cell's scene with its trainable
leaves perturbed by the run's seed (`traffic.perturb`), and builds the
program's `make_inverse_renderer` from the unperturbed scene; its first
`traffic.first_steps` steps are set-up too, and the same step object
then runs the window. A step is `step(seed)` under a seed of its own,
ended by reading the updated parameters on the host.

End to end: `step_s`, the window over its steps. A traced run takes the
workload's `trace.items` steps with the program's phase clock (which syncs
the card at each phase's end), as many under the device profiler, and
`trace.label_items` under the host one (profiling.py).

`correct`: the reference (reference/train.py) follows the first steps
from the same scene, target and seeds: the first from the scene itself,
each later one from the state the program reached (its leaves and Adam's
moments), since two runs that part on one near-tangent hit move their
spheres apart. The run compares each step's loss (`loss_gap`), its
gradient as the optimizer got it, from Adam's moments (`grad_gap` over
`check.leaves` by the gap of norms; `grad_row_gap` over every leaf by its
median row), its change of the leaves by the gap of norms
(`change_gap`), and its update against Adam's worked out from the
program's own state (`update_gap`). Every leaf's gaps are printed beside
them (`look`): the geometric and fuzz leaves' gradient norms are carried
by a few near-tangent hits and swing with rounding, float32 against
float64 as much as the program against the reference (PERF.md).

The target is the reference's: its seconds (`target_s`) are not set-up's.
"""

from __future__ import annotations

import time

from benchmark import profiling
from benchmark.harness import Check, Result, int_seeds, port_camera, port_scene, seed_stream


def perturbed(sc, seed: int, spec: dict):
    """`sc` with each trainable leaf perturbed from stream 3 of `seed`:
    colours scaled by up to +-spec["color"] (kept in [0, 1]), fuzz moved by
    up to +-spec["fuzz"] (kept >= 0), centres and radii moved by up to
    +-spec["center"] and +-spec["radius"]."""
    import torch

    g = seed_stream(seed, 3)

    def u(x, half):
        return torch.as_tensor(g.uniform(-half, half, tuple(x.shape)), dtype=x.dtype,
                               device=x.device)

    return sc.replace(
        tex_c0=torch.clamp(sc.tex_c0 * (1.0 + u(sc.tex_c0, spec["color"])), 0.0, 1.0),
        mat_albedo=torch.clamp(sc.mat_albedo * (1.0 + u(sc.mat_albedo, spec["color"])), 0.0, 1.0),
        mat_fuzz=torch.clamp(sc.mat_fuzz + u(sc.mat_fuzz, spec["fuzz"]), min=0.0),
        sph_center=sc.sph_center + u(sc.sph_center, spec["center"]),
        sph_radius=sc.sph_radius + u(sc.sph_radius, spec["radius"]))


def run(ctx) -> Result:
    import torch

    from benchmark.reference import compare, tracer
    from benchmark.reference import train as reference
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer
    from raytracer_tpu_torch.utils import launches

    cell, traffic = ctx.cell, ctx.cell.workload["traffic"]
    width, height = cell.size
    spp, max_depth = cell.spp, cell.max_depth
    trainable = tuple(traffic["trainable"])
    t = time.perf_counter()
    desc = cell.description()
    ref_scene = tracer.scene_from_description(desc, ctx.device)
    with torch.no_grad():
        target = reference.image(perturbed(ref_scene, ctx.seed, traffic["perturb"]), cell.camera,
                                 int_seeds(ctx.seed, 5, 1)[0], spp=spp, max_depth=max_depth)
    ctx.sync()
    t = ctx.part("target_s", t)
    cam, _ = port_camera(cell.camera, spp, max_depth)
    params, optimizer, step = make_inverse_renderer(
        port_scene(desc), cam, target, trainable=trainable, width=width, height=height,
        samples_per_pass=spp, max_depth=max_depth,
        sky_gradient=cell.camera.get("sky_gradient", False), learning_rate=traffic["lr"],
        backend=traffic["backend"], device=ctx.device)
    t = ctx.part("build_s", t)

    def host_params():
        return torch.cat([p.detach().reshape(-1) for p in params.values()]).cpu()

    def state():
        """The leaves and Adam's moments (zero where the optimizer holds none)."""
        def moment(p, name):
            m = optimizer.state.get(p, {}).get(name)
            return torch.zeros_like(p) if m is None else m.detach().clone()

        return {"params": {k: p.detach().clone() for k, p in params.items()},
                **{name: {k: moment(p, name) for k, p in params.items()}
                   for name in ("exp_avg", "exp_avg_sq")}}

    first_seeds = int_seeds(ctx.seed, 4, traffic["first_steps"])
    program = {"losses": [], "start": state()["params"], "states": []}
    for i, seed in enumerate(first_seeds):
        program["losses"].append(float(step(seed)))
        host_params()
        program["states"].append(state())
        t = ctx.part(f"step{i}_s", t)

    seeds = seed_stream(ctx.seed, 0)
    record, timings = None, []
    t_start = time.perf_counter()
    ctx.setup_s = t_start - ctx.start - ctx.setup_parts["target_s"]
    if ctx.trace:
        cuda, items = ctx.device == "cuda", cell.trace_items

        def item():
            step(int(seeds.integers(0, 2**31 - 1)))
            host_params()

        for _ in range(items):
            timings.append({})
            step(int(seeds.integers(0, 2**31 - 1)), timings[-1])
            host_params()
        launches.reset()
        record = profiling.device_stretch(item, items, cuda)
        record.extra.update({"launches": launches.read(), "timings": timings})
        record.idle_gaps = profiling.label_stretch(item, cell.workload["trace"]["label_items"],
                                                   cuda)
        n_done = 2 * items + cell.workload["trace"]["label_items"]
    else:
        n_done = 0
        while n_done == 0 or time.perf_counter() - t_start < ctx.seconds:
            step(int(seeds.integers(0, 2**31 - 1)))
            host_params()
            n_done += 1
    window = time.perf_counter() - t_start
    ctx.close_window()
    del params, optimizer, step

    result = Result(attempted=n_done, failed=0, record=record)
    if not ctx.trace:
        result.end_to_end = {"setup_s": ctx.setup_s, "step_s": window / n_done}
    t = time.perf_counter()
    ref = reference.follow(ref_scene, cell.camera, target, first_seeds, spp=spp,
                           max_depth=max_depth, lr=traffic["lr"], trainable=trainable,
                           states=program["states"])
    numbers = compare.train_numbers(program, ref, cell.check, traffic["lr"])
    limits = cell.check["limits"]
    result.checks = [Check(k, v, limits[k]) for k, v in numbers.items()]
    result.look = {**compare.train_look(program, ref), "check_s": time.perf_counter() - t}
    return result
