"""The port's span recorder (raytracer_tpu_torch/utils/trace.py) on the CPU:
off by default and invisible to a profiler, spans nested with their
parents, items and self times, on the profiler's timeline, the span trees
of an image and of a train step, outputs bit-equal with the recorder on
and off, the train steps' `timings` keys, the edge terms' spans and
counters, and the host-sync counter with its restore. Two `cuda`-marked
tests count syncs on the card; this file imports no JAX, so it runs there
as it is:

    python -m pytest --noconftest -o markers="cuda: needs a CUDA device" \\
        -m cuda tests/test_torch_trace.py
"""

import time
import warnings

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from raytracer_tpu_torch.diff.grad import make_inverse_renderer
from raytracer_tpu_torch.render.driver import render_image
from raytracer_tpu_torch.render.postprocess import to_u8
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(1)

RENDER_SPANS = {"render_image", "render/pack", "render/chunk", "render/kernel", "render/fold",
                "render/mean", "to_u8"}
STEP_PHASES = ("tape_forward", "loss_cotangent", "replay_forward", "backward", "optimizer")
EDGE_TERMS = ("boundary", "shadow")
EDGE_PARTS = ("sample", "trace", "splat")


@pytest.fixture
def recorder():
    """The recorder on for the test, off and emptied after it."""
    trace.collect()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.collect()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_render():
    scene, cam, st = get_scene("rand_spheres", width=16, spp=2, max_depth=4)
    img = render_image(scene, cam, st, device="cpu", seed=3)
    return img, to_u8(img)


def train_step(seed=1, steps=1, timings=None):
    """make_inverse_renderer's bucketed step on a tiny rand_spheres, run
    `steps` times: (losses, params, optimizer)."""
    scene, cam, st = get_scene("rand_spheres", width=16, spp=2, max_depth=4)
    target = torch.full((st.height, st.width, 3), 0.5)
    params, opt, step = make_inverse_renderer(
        scene, cam, target, width=st.width, height=st.height, samples_per_pass=2, max_depth=4,
        backend="bucketed", device="cpu")
    losses = [step(seed + i, timings) for i in range(steps)]
    return losses, params, opt


def edge_step(seed=1, device="cpu"):
    """One bucketed step with the primary-silhouette and shadow-edge terms
    on a tiny simple_light (four spheres, so every edge sample is taken)."""
    scene, cam, st = get_scene("simple_light", width=16, spp=2, max_depth=4)
    target = torch.full((st.height, st.width, 3), 0.5)
    _, _, step = make_inverse_renderer(
        scene, cam, target, width=st.width, height=st.height, samples_per_pass=2, max_depth=4,
        boundary=True, shadow_edges=True, backend="bucketed", device=device)
    return step(seed)


class SyncingOps(TorchDispatchMode):
    """Counts the operations that make a CUDA host wait: a tensor read as a
    Python number, nonzero, masked_select, unique and indexing by a boolean
    mask."""

    NAMES = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        masks = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] if i is not None)
        self.n += name in self.NAMES or masks
        return func(*args, **(kwargs or {}))


def tree(spans):
    """{name: parent's name} of collected spans."""
    names = {s["id"]: s["name"] for s in spans}
    return {s["name"]: names.get(s["parent"]) for s in spans}


def test_off_by_default_records_nothing():
    trace.collect()
    assert trace.span("a") is trace.span("b")  # the one shared no-op context
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        small_render()
    assert trace.collect() == []
    assert not RENDER_SPANS & {e.name for e in prof.events()}


def test_nesting_items_and_self_time(recorder):
    with trace.span("root"):
        with trace.span("a"):
            time.sleep(0.01)
            with trace.span("a/inner"):
                time.sleep(0.01)
        with trace.span("b"):
            trace.count("things", 3)
    with trace.span("second"):
        pass
    spans = {s["name"]: s for s in trace.collect()}
    root, a, inner, b = spans["root"], spans["a"], spans["a/inner"], spans["b"]
    assert root["parent"] is None and a["parent"] == b["parent"] == root["id"]
    assert inner["parent"] == a["id"]
    assert {s["item"] for s in (root, a, inner, b)} == {root["id"]}
    assert spans["second"]["item"] == spans["second"]["id"] != root["id"]
    assert a["self_ms"] == pytest.approx(a["host_ms"] - inner["host_ms"])
    assert root["self_ms"] == pytest.approx(root["host_ms"] - a["host_ms"] - b["host_ms"])
    assert inner["host_ms"] >= 10 and a["host_ms"] >= 20
    assert b["counts"] == root["counts"] == {"things": 3} and a["counts"] == {}
    assert all(s["device_ms"] is None and s["launches"] == 0 for s in spans.values())
    assert trace.collect() == []


def test_spans_lie_on_the_profilers_timeline(recorder):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        small_render()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    by_name = {e.name: e.time_range for e in events if e.name in RENDER_SPANS}
    assert set(by_name) == RENDER_SPANS

    def within(inner, outer):
        return outer.start <= inner.start and inner.end <= outer.end

    assert within(by_name["render/fold"], by_name["render/chunk"])
    assert within(by_name["render/kernel"], by_name["render/chunk"])
    assert within(by_name["render/chunk"], by_name["render_image"])
    assert within(by_name["render/pack"], by_name["render_image"])
    assert by_name["to_u8"].start >= by_name["render_image"].end


def test_render_span_tree(recorder):
    small_render()
    spans = trace.collect()
    assert tree(spans) == {"scene/build": None, "render_image": None,
                           "render/pack": "render_image",
                           "render/chunk": "render_image", "render/kernel": "render/chunk",
                           "render/fold": "render/chunk", "render/mean": "render_image",
                           "to_u8": None}
    image = {s["item"] for s in spans if s["name"].startswith("render")}
    assert len(image) == 1


def test_train_step_span_tree_and_counters(recorder):
    train_step()
    spans = trace.collect()
    t = tree(spans)
    assert t["build"] is None and t["step"] is None
    assert {n for n, p in t.items() if p == "build"} == {"build/optimizer"}
    assert {n for n, p in t.items() if p == "step"} == set(STEP_PHASES)
    replay = next(s for s in spans if s["name"] == "replay_forward")
    assert 1 <= replay["counts"]["bounces"] <= 4
    assert replay["counts"]["lanes"] >= replay["counts"]["bounces"]
    step = next(s for s in spans if s["name"] == "step")
    assert {s["item"] for s in spans if s["name"] in STEP_PHASES} == {step["id"]}


def test_edge_spans_and_counters_add_no_sync(monkeypatch):
    """Each edge term's phase holds its `sample`, `trace` and `splat` spans,
    with `edge_points` and `edge_rays` counted; with the recorder on, the
    terms make no more syncing operations than with it off."""
    from raytracer_tpu_torch.diff import bucketed

    compose, syncing = bucketed.compose_edges, []

    def counted(*args, **kwargs):
        with SyncingOps() as mode:
            out = compose(*args, **kwargs)
        syncing.append(mode.n)
        return out

    monkeypatch.setattr(bucketed, "compose_edges", counted)
    edge_step()
    trace.collect()
    trace.enable()
    try:
        edge_step()
        spans = trace.collect()
    finally:
        trace.disable()
        trace.collect()
    assert syncing[0] == syncing[1] > 0
    t = tree(spans)
    assert {t[f"edges/{term}"] for term in EDGE_TERMS} == {"edges"} and t["edges"] == "step"
    for term in EDGE_TERMS:
        assert {t[f"edges/{term}/{part}"] for part in EDGE_PARTS} == {f"edges/{term}"}
        mine = [s for s in spans if s["name"].startswith(f"edges/{term}/")]
        points = sum(s["counts"].get("edge_points", 0) for s in mine)
        rays = sum(s["counts"].get("edge_rays", 0) for s in mine)
        assert points > 0 and rays > 0
        assert all(s["counts"].get("lanes", 0) > 0 for s in mine
                   if s["name"].endswith("/trace"))


@pytest.mark.cuda
def test_edge_counters_take_no_sync_on_the_card(cuda, monkeypatch):
    """The syncs inside the edge terms with their counters counting and with
    `edge_points` and `edge_rays` dropped are the same."""
    count = trace.count

    def syncs():
        trace.collect()
        trace.enable()
        try:
            edge_step(device=cuda)
            return sum(s["syncs"] for s in trace.collect() if s["name"] == "edges")
        finally:
            trace.disable()
            trace.collect()

    edge_step(device=cuda)
    counting = syncs()
    monkeypatch.setattr(trace, "count", lambda key, n=1: None if key.startswith("edge_")
                        else count(key, n))
    assert syncs() == counting


def test_sharded_step_phases_cover_the_replay_set_up(recorder):
    """The sharded step at one in-process gloo rank: its `timings` keys, and
    its phases in order, the replay's lane set-up in a `replay_forward` of
    its own before the replay's."""
    from raytracer_tpu_torch.diff.grad import split_scene
    from raytracer_tpu_torch.parallel import mesh as pmesh
    from raytracer_tpu_torch.parallel.train import make_sharded_bucketed_grad_fn

    scene, cam, st = get_scene("rand_spheres", width=16, spp=2, max_depth=4)
    params, rebuild = split_scene(scene)
    target = torch.full((st.height, st.width, 3), 0.5)
    timings = {}
    pmesh.init_group("cpu")
    try:
        step = make_sharded_bucketed_grad_fn(rebuild, cam, target, pmesh.make_mesh(),
                                             width=st.width, height=st.height,
                                             samples_per_pass=2, max_depth=4)
        trace.collect()
        step(params, 5, timings)
    finally:
        pmesh.close_group()
    phases = ["tape_forward", "image_all_reduce", "loss_cotangent", "replay_forward",
              "replay_forward", "backward", "grad_all_reduce"]
    assert set(timings) == set(phases) and all(v > 0 for v in timings.values())
    spans = sorted((s for s in trace.collect() if s["parent"] is None),
                   key=lambda s: s["start_ns"])
    assert [s["name"] for s in spans] == phases
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(spans, spans[1:]))


def test_outputs_bit_equal_with_the_recorder_on_and_off():
    img_off, u8_off = small_render()
    losses_off, params_off, opt_off = train_step(steps=2)
    trace.enable()
    try:
        img_on, u8_on = small_render()
        losses_on, params_on, opt_on = train_step(steps=2)
    finally:
        trace.disable()
        trace.collect()
    assert torch.equal(img_on, img_off) and torch.equal(u8_on, u8_off)
    assert all(torch.equal(a, b) for a, b in zip(losses_on, losses_off))
    for k in params_off:
        p_on, p_off = params_on[k], params_off[k]
        assert torch.equal(p_on.detach(), p_off.detach()) and torch.equal(p_on.grad, p_off.grad)
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt_on.state[p_on][name], opt_off.state[p_off][name])


@pytest.mark.parametrize("on", [False, True])
def test_timings_keys_unchanged(on):
    if on:
        trace.enable()
    try:
        timings = {}
        train_step(timings=timings)
    finally:
        trace.disable()
        trace.collect()
    assert set(timings) == set(STEP_PHASES)
    assert all(v > 0 for v in timings.values())


def test_sync_counter_counts_and_restores():
    before_filters = warnings.filters[:]
    before_show = warnings.showwarning
    trace.enable()
    try:
        with trace.span("outer"):
            with trace.span("inner"):
                warnings.warn(trace.SYNC_WARNING, UserWarning)
            with warnings.catch_warnings(record=True) as other:
                warnings.simplefilter("always")
                warnings.warn("something else", UserWarning)
        spans = {s["name"]: s for s in trace.collect()}
    finally:
        trace.disable()
    assert spans["inner"]["syncs"] == 1 and spans["outer"]["syncs"] == 1
    assert [str(w.message) for w in other] == ["something else"]
    assert warnings.filters == before_filters and warnings.showwarning is before_show
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        warnings.warn(trace.SYNC_WARNING, UserWarning)
    assert len(seen) == 1  # off, a sync warning is no longer swallowed


@pytest.mark.cuda
def test_sync_counter_on_the_card(cuda):
    """One sync each for item, nonzero, a boolean-mask index and a copy to
    the host; none for an elementwise add; the debug mode restored."""
    x = torch.arange(-2.0, 6.0, device=cuda)
    cases = {"item": lambda: x[3].item(), "nonzero": lambda: torch.nonzero(x),
             "mask": lambda: x[x > 0], "cpu": lambda: x.cpu(), "add": lambda: x + 1}
    mode = torch.cuda.get_sync_debug_mode()
    trace.enable()
    try:
        for name, fn in cases.items():
            with trace.span(name):
                fn()
        spans = trace.collect()
    finally:
        trace.disable()
    assert {s["name"]: s["syncs"] for s in spans} == {
        "item": 1, "nonzero": 1, "mask": 1, "cpu": 1, "add": 0}
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in spans)
    assert torch.cuda.get_sync_debug_mode() == mode
