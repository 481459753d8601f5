"""Train job with the visibility terms: inverse rendering by the full
gradient a user recovering geometry runs, the interior's plus the primary
silhouettes' and the first-bounce shadow edges'
(`make_inverse_renderer(..., boundary=True, shadow_edges=True)`), one step
after another. Set-up, target, seeds and the timed loop are jobs/train.py's:
the target is the reference's render of the cell's scene with its
trainable leaves perturbed by the run's seed (`traffic.perturb`), the
first `traffic.first_steps` steps are set-up, and a step is `step(seed)`
ended by reading the updated parameters on the host. `traffic.edges`
names the terms, in the program's order; `traffic.edge_budget` holds the
budgets the program chooses for the scene (diff/grad.py:boundary_config,
shadow_config), which the job checks before it runs.

End to end: `step_s`, the window over its steps. A traced run takes the
workload's `trace.items` steps with the program's phase clock (which syncs
the card at each phase's end and times each term as `edges/<name>`), as
many under the device profiler, and `trace.label_items` under the host
one (profiling.py).

`correct`: the reference (reference/edges.py:follow_edges: the train
cell's float32 interior, the edge terms in float64) follows the first
steps from the same scene, target and seeds, each later one from the state
the program reached. The run compares each step's loss
(`loss_gap`) and its update against Adam's worked out from the program's
own state (`update_gap`), as the train cell does (reference/compare.py);
the gradient as Adam got it against the reference's interior plus edges,
the reference's own throughout (its image cotangent too), over
`sph_center` and `sph_radius` by the median row of the gap of norms
(`geo_grad_gap`); and each term alone (`edge_row_gap`): the program's,
`diff/bucketed.py:compose_edges` of the edge images that diff/grad.py's
budgets build, against the reference's, both at the program's state before
the step and its image cotangent (the tape forward's, diff/bucketed.py:
finish), over the sphere rows whose reference norm is above 0 by the
median of |row norm - row norm| / reference row norm, the worst term, leaf
and step. There the reference takes the program's cotangent, so that the
term is judged alone: the terms are linear in it, and its receiver draw
reads it. Every leaf's and term's gaps are printed beside them (`look`).

The target is the reference's: its seconds (`target_s`) are not set-up's.
"""

from __future__ import annotations

import time

import torch

from benchmark import profiling
from benchmark.harness import Check, Result, int_seeds, port_camera, port_scene, seed_stream
from benchmark.jobs.train import perturbed

GEOMETRY = ("sph_center", "sph_radius")
TERMS = ("boundary", "shadow")


def terms_gap(program: list, reference: list, leaves=GEOMETRY, terms=TERMS) -> dict:
    """Per term, the worst over leaves and steps of the median row gap
    (compare.row_gap) of the program's term against the reference's."""
    from benchmark.reference import compare

    return {name: compare.worst(compare.row_gap(p[name], r[name], [k]) for p, r in
                                zip(program, reference) for k in leaves) for name in terms}


def numbers(program: dict, reference: dict, lr: float) -> dict:
    """The numbers the cell compares (module docstring). `program` holds
    each step's loss, the leaves it started from, the state after each step
    and each step's edge terms (`terms`, {term: {leaf: gradient}}); the
    reference is follow_edges' at the program's states and cotangents."""
    from benchmark.reference import compare

    grads = zip(compare.run_grads(program), reference["grads"])
    return {"loss_gap": compare.worst(compare.loss_gaps(program["losses"],
                                                        reference["losses"])),
            "update_gap": compare.update_gap(program, lr, list(reference["grads"][0])),
            "geo_grad_gap": compare.worst(compare.row_gap(p, r, GEOMETRY) for p, r in grads),
            "edge_row_gap": compare.worst(terms_gap(program["terms"],
                                                    reference["terms"]).values())}


def look(program: dict, reference: dict) -> dict:
    """Each step's gap of every leaf's gradient by its median row and by the
    gap of norms, and each term's row gap, printed beside the numbers."""
    from benchmark.reference import compare

    grads = list(zip(compare.run_grads(program), reference["grads"]))
    leaves = list(reference["grads"][0])
    return {"loss_gaps": compare.loss_gaps(program["losses"], reference["losses"]),
            "grad_row_gaps": [{k: compare.row_gap(p, r, [k]) for k in leaves} for p, r in grads],
            "grad_gaps": [{k: compare.leaf_gap(p, r, [k]) for k in leaves} for p, r in grads],
            "edge_row_gaps": terms_gap(program["terms"], reference["terms"])}


def check_budget(scene, width: int, height: int, want: dict) -> None:
    """Raise unless the program's edge budgets for the scene are the
    workload's."""
    from raytracer_tpu_torch.diff.grad import boundary_config, shadow_config

    got = {"boundary": boundary_config(scene)._asdict(),
           "shadow": shadow_config(scene, width, height)._asdict()}
    for term, fields in want.items():
        for k, v in fields.items():
            if got[term][k] != v:
                raise ValueError(f"the program's {term} budget has {k}={got[term][k]}, "
                                 f"the workload {v}")


def program_terms(scene, cam, target, states: list, seeds: list, *, trainable, width: int,
                  height: int, spp: int, max_depth: int, sky_gradient: bool) -> tuple:
    """Each step's edge terms ({term: {leaf: gradient}}) and image cotangent,
    from the program at the state `states[i]` with the step's seed: the tape
    forward's image cotangent (diff/bucketed.py:tape_forward, finish), then
    diff/bucketed.py:compose_edges of each term's edge image alone, at its
    place in the step's list so that it takes the step's seed."""
    from raytracer_tpu_torch.diff import grad
    from raytracer_tpu_torch.diff.bucketed import compose_edges, finish, tape_forward

    _, rebuild = grad.split_scene(scene, trainable)
    kw = dict(width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient)
    fns = [grad.make_boundary_image_fn(rebuild, config=grad.boundary_config(scene), **kw),
           grad.make_shadow_boundary_fn(rebuild, config=grad.shadow_config(scene, width, height),
                                        **kw)]

    def absent(params, _cam, _seed):
        """A zero edge image in the other term's place."""
        anchor = next(iter(params.values()))
        return torch.zeros(height, width, 3, device=anchor.device) + 0.0 * anchor.sum()

    terms, cts = [], []
    for state, seed in zip(states, seeds):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()}
        with torch.no_grad():
            rad, tape = tape_forward(params, rebuild, None, cam, seed, spp * width * height,
                                     device=target.device, **kw)
            ct = finish(rad, tape, target, samples_per_pass=spp)[3]
        out = {}
        for i, name in enumerate(TERMS):
            alone = [fns[j] if j == i else absent for j in range(i + 1)]
            out[name] = compose_edges(alone, params, cam, seed, ct)
        terms.append(out)
        cts.append(ct)
    return terms, cts


def run(ctx) -> Result:
    from benchmark.reference import edges, tracer
    from benchmark.reference import train as reference
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer
    from raytracer_tpu_torch.utils import launches

    cell, traffic = ctx.cell, ctx.cell.workload["traffic"]
    if tuple(traffic["edges"]) != TERMS:
        raise ValueError(f"edges {traffic['edges']}: this job runs {list(TERMS)}")
    width, height = cell.size
    spp, max_depth = cell.spp, cell.max_depth
    trainable = tuple(traffic["trainable"])
    sky = cell.camera.get("sky_gradient", False)
    t = time.perf_counter()
    desc = cell.description()
    ref_scene = tracer.scene_from_description(desc, ctx.device)
    with torch.no_grad():
        target = reference.image(perturbed(ref_scene, ctx.seed, traffic["perturb"]), cell.camera,
                                 int_seeds(ctx.seed, 5, 1)[0], spp=spp, max_depth=max_depth)
    ctx.sync()
    t = ctx.part("target_s", t)
    scene = port_scene(desc)
    check_budget(scene, width, height, traffic["edge_budget"])
    cam, _ = port_camera(cell.camera, spp, max_depth)
    params, optimizer, step = make_inverse_renderer(
        scene, cam, target, trainable=trainable, width=width, height=height,
        samples_per_pass=spp, max_depth=max_depth, sky_gradient=sky,
        learning_rate=traffic["lr"], boundary=True, shadow_edges=True,
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
        record.extra.update({"launches": launches.read(), "timings": timings,
                             "spheres": len(desc.spheres), "quads": len(desc.quads),
                             "receiver_rays": width * height})
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
    before = [program["start"]] + [s["params"] for s in program["states"][:-1]]
    program["terms"], cts = program_terms(
        scene.to(target.device), cam, target, before, first_seeds, trainable=trainable,
        width=width, height=height, spp=spp, max_depth=max_depth, sky_gradient=sky)
    ref = edges.follow_edges(
        ref_scene, cell.camera, target, first_seeds, spp=spp, max_depth=max_depth,
        lr=traffic["lr"], trainable=trainable, states=program["states"], cts=cts)
    limits = cell.check["limits"]
    result.checks = [Check(k, v, limits[k]) for k, v in numbers(program, ref,
                                                                traffic["lr"]).items()]
    result.look = {**look(program, ref), "check_s": time.perf_counter() - t}
    return result
