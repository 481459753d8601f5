"""The sharded render over four ranks against the benchmark's plain
reference of the split (benchmark/reference/sharded.py), its spans and
counters, the rule by which a rank takes its card, and the benchmark's
four-rank cell run end to end on the CPU.

Four ranks run as gloo processes on the CPU (`four`: each a subprocess,
so no process group outlives a test) on seeded random scenes of the
benchmark's description (its sphere field under another grid seed), at
32x18, 8 spp, depth 8, under a log budget that forces two chunks. This
file imports no JAX."""

import json
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark.jobs import render_sharded
from benchmark.reference import compare, sharded
from raytracer_tpu_torch.core.camera import RenderSettings
from raytracer_tpu_torch.parallel import mesh as pmesh
from raytracer_tpu_torch.parallel import shard
from raytracer_tpu_torch.render import driver
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CELL = "rand_spheres_4k.render_sharded4"
RANKS = 4
WIDTH, SPP, DEPTH = 32, 8, 8
GRID_SEEDS = (3, 11)
ROULETTE = (5, 0.05, 0.75)
# One rank's chunk of 1 spp at 32x18 holds 576 lanes' log (12 * 576 B), its
# framebuffer (12 * 576 B) and no fold scratch: a budget of 2 * 6,912 B
# gives a chunk of 4 spp over four ranks, so 8 spp run in two chunks.
BUDGET = 2 * 12 * 576
# Both sides trace every sample in float32 from the same sample ids and
# seeds; they differ only in the order of float32 sums (the fold and the
# all-reduce against the reference's per-rank sums) and in the rounding of
# the closest hit's terms, about 1e-7 of a pixel. A path that parted at a
# near-tangent hit would move the gap by about 1e-4 at these 4,608
# samples; none does at these seeds (readings below 2e-8). A rank seeded
# as another, or a rank's samples dropped, reads above 1e-2.
PIXEL_GAP = 1e-5
RUN_TIMEOUT_S = 240


def description(grid_seed: int):
    cfg = harness.read_json(harness.ROOT / "configs" / "rand_spheres_4k.json")
    spheres = [{"grid": {**s["grid"], "seed": grid_seed}} if "grid" in s else s
               for s in cfg["scene"]["spheres"]]
    return scenes.describe({**cfg["scene"], "spheres": spheres}), {**cfg["camera"], "width": WIDTH}


def program_inputs(grid_seed: int):
    desc, camera = description(grid_seed)
    cam, settings = harness.port_camera(camera, SPP, DEPTH)
    return desc, camera, harness.port_scene(desc), cam, settings


def reference(grid_seed: int, seed: int):
    desc, camera = description(grid_seed)
    w, h = scenes.image_size(camera)
    return sharded.render_pixels(desc, camera, seed, torch.arange(w * h), spp=SPP,
                                 max_depth=DEPTH, roulette=ROULETTE, ranks=RANKS, device="cpu",
                                 budget=BUDGET)


# Each rank: `python -c WORKER rank world coordinator outdir`; it renders
# every grid seed with the recorder on and writes outdir/<rank>.json (the
# spans and each image's hash) and, rank 0, the images.
WORKER = r'''
import hashlib, json, sys, numpy as np, torch
sys.path.insert(0, sys.argv[5])
torch.set_num_threads(1)
from test_torch_sharded4 import BUDGET, GRID_SEEDS, program_inputs
from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
from raytracer_tpu_torch.parallel.shard import render_image_sharded
from raytracer_tpu_torch.render.postprocess import to_u8
from raytracer_tpu_torch.utils import trace
rank, world, coord, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_group("cpu", coordinator=coord, process_id=rank, num_processes=world)
res, imgs = {"spans": {}, "hash": {}}, {}
try:
    mesh = make_mesh()
    for g in GRID_SEEDS:
        _, _, scene, cam, settings = program_inputs(g)
        trace.collect()
        trace.enable()
        img = render_image_sharded(scene, cam, settings, mesh, seed=1000 + g,
                                   log_budget_bytes=BUDGET)
        to_u8(img)
        trace.disable()
        res["spans"][g] = trace.collect()
        res["hash"][g] = hashlib.sha256(img.numpy().tobytes()).hexdigest()
        imgs[str(g)] = img.numpy()
finally:
    close_group()
json.dump(res, open(f"{out}/{rank}.json", "w"))
if rank == 0:
    np.savez(f"{out}/images.npz", **imgs)
'''


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded4")
    coord = f"localhost:{render_sharded.free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(RANKS), coord, str(out), str(REPO / "tests")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    res = [json.load(open(out / f"{r}.json")) for r in range(RANKS)]
    with np.load(out / "images.npz") as z:
        imgs = {int(k): z[k] for k in z.files}
    return res, imgs


@pytest.mark.parametrize("grid_seed", GRID_SEEDS)
def test_four_ranks_match_the_reference(four, grid_seed):
    res, imgs = four
    ref, _, plan = reference(grid_seed, 1000 + grid_seed)
    assert plan == [4, 4]
    prog = torch.from_numpy(imgs[grid_seed]).reshape(-1, 3)
    assert compare.pixel_gap(prog, ref) <= PIXEL_GAP
    assert len({r["hash"][str(grid_seed)] for r in res}) == 1  # every rank ends with the image


def in_process(grid_seed: int, seed: int, partial):
    """The program's sharded image with each position's partial from
    `partial(renderer, step, chunk seed, position)`, summed here."""
    _, _, scene, cam, settings = program_inputs(grid_seed)
    renderer = driver.chunk_renderer(scene, cam, settings, torch.device("cpu"))
    chunk = driver.default_spp_chunk(scene, settings, log_budget_bytes=BUDGET, ranks=RANKS)
    acc, done, c = torch.zeros(settings.width * settings.height, 3), 0, 0
    while done < SPP:
        step = min(chunk, SPP - done)
        for p in range(RANKS):
            acc = acc + partial(renderer, step, driver.chunk_seed(seed, c), p)
        done, c = done + step, c + 1
    return acc / float(SPP)


def duplicate_seed(renderer, step, seed, p):
    """Rank 1 traced under rank 0's seed."""
    share = shard.rank_share(step, p, RANKS)
    return renderer.render(share, shard.rank_seed(seed, 0 if p == 1 else p))[0]


def dropped_rank(renderer, step, seed, p):
    """Rank 3's samples left out, the other ranks' scaled by 4/3."""
    fb = driver.regen_partial(renderer, step, seed, p, RANKS)[0]
    return torch.zeros_like(fb) if p == 3 else fb * (4.0 / 3.0)


def test_in_process_partials_match_the_reference():
    """The sum of the four positions' partials, worked out in one process,
    is what the reference reads: the yardstick the planted faults break."""
    g = GRID_SEEDS[0]
    sound = in_process(g, 77, lambda r, step, s, p: driver.regen_partial(r, step, s, p, RANKS)[0])
    assert compare.pixel_gap(sound, reference(g, 77)[0]) <= PIXEL_GAP


@pytest.mark.parametrize("fault", [duplicate_seed, dropped_rank])
def test_a_planted_fault_fails_the_reference(fault):
    g = GRID_SEEDS[0]
    assert compare.pixel_gap(in_process(g, 77, fault), reference(g, 77)[0]) > 1e-2


@pytest.mark.parametrize("n_pixels,spp,budget", [
    (576, SPP, BUDGET),
    (576, 13, BUDGET),
    (576, 8, 12 * 576),
    (3840 * 2160, 64, sharded.LOG_BUDGET_BYTES),
    (3840 * 2160, 500, sharded.LOG_BUDGET_BYTES),
    (400 * 225, 500, sharded.LOG_BUDGET_BYTES),
    (400 * 225, 500, 64 << 20),
])
def test_reference_chunk_plan_is_the_programs(n_pixels, spp, budget):
    """The reference's own chunk plan against the program's
    default_spp_chunk(ranks=4) on a persistent-path scene of that size."""
    _, _, scene, cam, settings = program_inputs(GRID_SEEDS[0])
    width = {576: 32, 3840 * 2160: 3840, 400 * 225: 400}[n_pixels]
    settings = RenderSettings(width, n_pixels // width, spp, DEPTH, False)
    chunk = driver.default_spp_chunk(scene, settings, log_budget_bytes=budget, ranks=RANKS)
    program = [min(chunk, spp - done) for done in range(0, spp, chunk)]
    assert sharded.chunk_plan(n_pixels, spp, RANKS, budget) == program
    if budget < 1 << 20:
        assert len(program) > 1


def test_spans_and_counters_of_each_rank(four):
    res, _ = four
    n_pix = WIDTH * 18
    ref_segments = {g: reference(g, 1000 + g)[1] for g in GRID_SEEDS}
    for g in GRID_SEEDS:
        segments = 0
        for r in res:
            spans = r["spans"][str(g)]
            names = {s["id"]: s["name"] for s in spans}
            roots = [s for s in spans if s["parent"] is None]
            assert sorted(s["name"] for s in roots) == ["render_image_sharded", "to_u8"]
            root = next(s for s in roots if s["name"] == "render_image_sharded")
            parents = {s["name"]: names.get(s["parent"]) for s in spans}
            assert parents["render/pack"] == parents["render/chunk"] == "render_image_sharded"
            assert parents["render/all_reduce"] == parents["render/mean"] == "render_image_sharded"
            assert parents["render/kernel"] == parents["render/fold"] == "render/chunk"
            reduces = [s for s in spans if s["name"] == "render/all_reduce"]
            assert len(reduces) == len([s for s in spans if s["name"] == "render/chunk"]) == 2
            assert all(s["counts"] == {"all_reduce_bytes": 12 * n_pix} for s in reduces)
            assert root["counts"]["all_reduce_bytes"] == 2 * 12 * n_pix
            segments += root["counts"]["rank_segments"]
        assert segments == pytest.approx(ref_segments[g], rel=1e-3)


def test_host_syncs_count_under_the_root(monkeypatch):
    """A sync inside a chunk's partial counts toward the chunk's span and
    the root `render_image_sharded` (one in-process gloo rank)."""
    _, _, scene, cam, settings = program_inputs(GRID_SEEDS[0])
    partial = driver.regen_partial

    def syncing(*args):
        warnings.warn(trace.SYNC_WARNING, UserWarning)
        return partial(*args)

    monkeypatch.setattr(driver, "regen_partial", syncing)
    pmesh.init_group("cpu")
    trace.collect()
    trace.enable()
    try:
        # Chunks of 2 spp at one rank: four chunks.
        shard.render_image_sharded(scene, cam, settings, pmesh.make_mesh(), seed=5,
                                   log_budget_bytes=sharded.chunk_bytes(576, 2))
    finally:
        trace.disable()
        pmesh.close_group()
    spans = trace.collect()
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    assert [s["syncs"] for s in by["render/chunk"]] == [1, 1, 1, 1]
    assert by["render_image_sharded"][0]["syncs"] == 4
    assert by["render/all_reduce"][0]["syncs"] == 0


def test_tensor_counts_and_gather_without_a_group():
    trace.collect()
    trace.enable()
    try:
        for n in (1, 2):
            with trace.span("root"):
                with trace.span("inner"):
                    trace.count("things", torch.tensor(n))
                    trace.count("things", 10)
    finally:
        trace.disable()
    spans = trace.collect()
    assert [s["counts"] for s in spans if s["name"] == "inner"] == [{"things": 11},
                                                                    {"things": 12}]
    totals = render_sharded.item_totals(spans)
    assert [(t["inner"]["things"], t["root"]["things"]) for t in totals] == [(11, 11), (12, 12)]
    assert trace.gather(spans) == [spans]


@pytest.mark.parametrize("env,rank,cards,card", [
    ({"LOCAL_RANK": "3"}, 1, 4, 3),
    ({}, 2, 4, 2),
    ({}, 5, 4, 1),
    ({}, None, 4, 0),
])
def test_a_rank_takes_its_own_card(monkeypatch, env, rank, cards, card):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pmesh.local_card(rank, cards) == card


def test_init_group_with_a_coordinator_and_no_local_rank(monkeypatch):
    """Four ranks started one by one with a coordinator take cards 0-3,
    not each cuda:0."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    chosen = []

    class Started(Exception):
        pass

    def init_process_group(*a, **kw):
        raise Started

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: chosen.append(d.index))
    monkeypatch.setattr(pmesh.dist, "init_process_group", init_process_group)
    for r in range(4):
        with pytest.raises(Started):
            pmesh.init_group("cuda", coordinator="localhost:1", process_id=r, num_processes=4)
    assert chosen == [0, 1, 2, 3]


def test_a_group_that_never_forms_ends_the_run():
    failed = threading.Event()
    children = render_sharded.Children([[sys.executable, "-c", "import time; time.sleep(60)"]],
                                       on_failure=failed.set, setup_s=1.0)
    try:
        assert failed.wait(30)
        assert children.procs[0].poll() is not None
    finally:
        children.kill()


def test_a_failing_child_ends_the_run_and_the_others():
    failed = threading.Event()
    children = render_sharded.Children(
        [[sys.executable, "-c", "import time; time.sleep(60)"],
         [sys.executable, "-c", "raise SystemExit(3)"]], on_failure=failed.set)
    try:
        assert failed.wait(30)
        assert [p.poll() is not None for p in children.procs] == [True, True]
        assert children.procs[1].returncode == 3
    finally:
        children.kill()


def test_the_cell_runs_on_the_cpu_and_leaves_no_process():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELL, "--seed", str(2**31 + 99),
         "--seconds", "0.5", "--trace", "0", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"pixel_gap", "u8_off", "rank_image_mismatch", "rank_devices",
                                  "chunk_count_off"}
    assert set(out["metrics"]) == {"setup_s", "msamples_per_s", "image_p95_s"}
    line = next(x for x in proc.stderr.splitlines() if x.startswith("ranks "))
    pids = json.loads(line[len("ranks "):])
    assert len(pids) == RANKS
    time.sleep(0.5)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_rank_wait_reads_each_images_spread_over_the_ranks():
    from benchmark.profiling import TraceRecord
    from benchmark.run import metric_reader

    def items(*ms):  # per image: the root's totals and, on rank 0, a to_u8 item
        return [t for m in ms for t in ({"render_image_sharded": {"n": 1},
                                         "render/all_reduce": {"n": 1, "device_ms": m}},
                                        {"to_u8": {"n": 1}})]

    read = metric_reader("rank_wait_ms.sharded")
    rec = TraceRecord(extra={"spans": {"ranks": [items(1.0, 2.0), items(3.0, 2.5),
                                                  items(1.5, 2.0), items(1.0, 5.0)]}})
    assert read(rec) == pytest.approx(((3.0 - 1.0) + (5.0 - 2.0)) / 2)
    rec.extra["spans"]["ranks"][1] = items(3.0)
    assert read(rec) is None
    rec.extra["spans"]["ranks"] = [items(None, None)] * 4
    assert read(rec) is None
    assert read(TraceRecord()) is None
