"""The span stretch (benchmark/spans.py): its attribution on synthetic
profiler events, its process run on the CPU, and the eight metrics that
read it on a synthetic record, None where there is nothing to read."""

import json
import subprocess
import sys

import pytest

from benchmark import harness, spans
from benchmark.profiling import SPAN, TraceRecord
from benchmark.run import metric_reader, parse

NEW = ("pack_ms.render", "fold_ms.render", "fold_ops.render", "host_syncs.render",
       "host_syncs.train", "replay_idle_ms.train", "backward_idle_ms.train",
       "step_build_s.train")


def event(name, start, end, device=False, corr=0, link=0, annotation=False):
    return spans.Event(name, not device, start, end, corr, link, annotation)


def test_innermost_labels_the_shortest_cover():
    pieces = spans.innermost([(0, 100, "step"), (10, 40, "replay_forward"),
                              (40, 90, "backward")])
    assert [spans.label_at(pieces, t) for t in (-5, 5, 10, 39, 40, 95, 100, 200)] == [
        "outside", "step", "replay_forward", "replay_forward", "backward", "step", "outside",
        "outside"]
    assert spans.label_at(spans.innermost([]), 3) == "outside"


def test_attribute_puts_ops_and_gaps_under_spans():
    """One item [0, 100] ns: step [0, 95] holds replay_forward [5, 40] and
    backward [40, 90]. A kernel launched by an op inside replay_forward, one
    by an op inside backward (whose correlation id a later host event
    shares), one linked to no host operation, and the device side of a
    span's range, which is no operation."""
    events = [
        event(SPAN, 0, 100, corr=1), event("step", 0, 95, corr=2),
        event("replay_forward", 5, 40, corr=3), event("backward", 40, 90, corr=4),
        event("aten::mul", 10, 12, corr=7), event("cudaLaunchKernel", 11, 12, corr=70, link=7),
        event("aten::index", 50, 52, corr=8), event("aten::sum", 60, 61, corr=8),
        event("kern_a", 20, 30, device=True, corr=70, link=7),
        event("kern_b", 60, 80, device=True, corr=80, link=8),
        event("kern_c", 85, 88, device=True, corr=90),
        event("replay_forward", 5, 40, device=True, link=3, annotation=True),
    ]
    out = spans.attribute(events, {"step", "replay_forward", "backward"})
    assert out["device_ops"] == {"replay_forward": 1, "backward": 1, "unlinked": 1}
    assert out["device_ms"] == pytest.approx({"replay_forward": 1e-5, "backward": 2e-5,
                                              "unlinked": 3e-6})
    # Gaps: [0, 20] mid 10 replay_forward, [30, 60] mid 45 backward,
    # [80, 85] mid 82.5 backward, [88, 100] mid 94 step.
    assert out["idle_ms"] == pytest.approx({"replay_forward": 2e-5, "backward": 3.5e-5,
                                            "step": 1.2e-5})
    assert out["idle_ms_measured"] == pytest.approx(sum(out["idle_ms"].values()))


def test_measured_idle_is_read_apart_from_the_gaps():
    """The measured idle sums the operations' durations: two that overlap,
    or one that outlasts its item, read less idle than the labelled gaps,
    which is what the comparison of the two is for."""
    items = [[0, 100], [200, 300]]
    ops = [event("k1", 10, 30, device=True), event("k2", 20, 40, device=True),
           event("k3", 290, 320, device=True), event("k4", 150, 160, device=True)]
    assert spans.measured_idle_ms(items, ops) == pytest.approx((200 - 20 - 20 - 30) / 1e6)
    out = spans.attribute([event(SPAN, 0, 100, corr=1), event(SPAN, 200, 300, corr=2), *ops],
                          set())
    assert sum(out["idle_ms"].values()) == pytest.approx((200 - 30 - 10) / 1e6)
    assert out["idle_ms_measured"] < sum(out["idle_ms"].values())


def test_nothing_to_read_outside_a_traced_card_run(monkeypatch):
    """No second process runs, and the new metrics read None: outside a run
    of benchmark.run (here), on the CPU, untraced, and over a program with
    no recorder, as the traced runs of a parent commit have it."""
    ran = []
    monkeypatch.setattr(spans.subprocess, "run", lambda *a, **k: ran.append(a))
    assert all(metric_reader(m)(TraceRecord()) is None for m in NEW)
    main = type(sys)("benchmark.run")
    main.__spec__ = type("Spec", (), {"name": "benchmark.run"})()
    main.parse = parse
    monkeypatch.setitem(sys.modules, "__main__", main)
    for argv, recorder in ((["--device", "cpu"], True), (["--trace", "0"], True), ([], False)):
        monkeypatch.setattr(sys, "argv", ["run", "--workload", "rand_spheres.train", "--seed",
                                          "1", "--seconds", "1", "--trace", "1", *argv])
        monkeypatch.setattr(spans, "has_recorder", lambda: recorder)
        assert all(metric_reader(m)(TraceRecord()) is None for m in NEW)
    assert ran == []


def test_a_traced_card_run_reads_the_second_process(monkeypatch, capsys):
    """Under benchmark.run with a card, the first reader runs
    `python3 -m benchmark.spans` with the run's workload and seed, once, and
    every reader reads its summary."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        rec = synthetic(render=False)
        return subprocess.CompletedProcess(cmd, 0, "noise\n" + json.dumps(rec.extra["spans"]),
                                           "")

    main = type(sys)("benchmark.run")
    main.__spec__ = type("Spec", (), {"name": "benchmark.run"})()
    main.parse = parse
    monkeypatch.setitem(sys.modules, "__main__", main)
    monkeypatch.setattr(sys, "argv", ["run", "--workload", "rand_spheres.train", "--seed",
                                      str(2**31 + 5), "--seconds", "30", "--trace", "1"])
    monkeypatch.setattr(spans.subprocess, "run", fake_run)
    rec = TraceRecord()
    read = {m: metric_reader(m)(rec) for m in NEW if m.endswith(".train")}
    assert read == {"host_syncs.train": 200.0, "replay_idle_ms.train": 100.0,
                    "backward_idle_ms.train": 450.0, "step_build_s.train": 6.5}
    assert calls == [[sys.executable, "-m", "benchmark.spans", "--workload",
                      "rand_spheres.train", "--seed", str(2**31 + 5), "--device", "cuda"]]
    assert capsys.readouterr().err.startswith("spans {")


def test_a_failed_second_process_raises(monkeypatch):
    main = type(sys)("benchmark.run")
    main.__spec__ = type("Spec", (), {"name": "benchmark.run"})()
    main.parse = parse
    monkeypatch.setitem(sys.modules, "__main__", main)
    monkeypatch.setattr(sys, "argv", ["run", "--workload", "cornell.render", "--seed", "3",
                                      "--seconds", "30", "--trace", "1"])
    monkeypatch.setattr(spans.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "", "boom"))
    with pytest.raises(RuntimeError, match="boom"):
        metric_reader("pack_ms.render")(TraceRecord())


@pytest.mark.parametrize("cell", ["rand_spheres.preview", "rand_spheres.train"])
def test_span_process_runs_the_job_on_the_cpu(cell):
    """`python3 -m benchmark.spans` at the cell's CPU shapes: the job's set-up
    with the recorder on, then in place of its device stretch the same
    items with the recorder off and on, and the job stops there; one JSON
    line of the summary."""
    proc = subprocess.run([sys.executable, "-m", "benchmark.spans", "--workload", cell,
                           "--seed", str(2**31 + 9), "--device", "cpu"],
                          cwd=harness.REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    n = harness.Cell.load(cell, cpu=True).trace_items
    assert out["cuda"] is False and out["items"] == n
    assert len(out["item_s"]) == n and len(out["off_item_s"]) == n
    assert set(out["seconds"]) == {"setup", "off_stretch", "items", "profiler_stop",
                                   "attribute", "run_job"}
    assert "idle_ms" not in out
    names = set(out["by_name"])
    if cell.endswith(".train"):
        assert {"step", "tape_forward", "replay_forward", "backward", "optimizer"} <= names
        assert out["by_name"]["step"]["n"] == n
        assert "build" in out["setup"] and "step" in out["setup"]  # the first steps
    else:
        assert {"render_image", "render/pack", "render/chunk", "render/fold",
                "render/mean", "to_u8"} <= names
        assert out["by_name"]["render_image"]["n"] == n
        assert "scene/build" in out["setup"] and "render_image" in out["setup"]  # warm images


def test_setup_ends_at_the_first_timed_item():
    """The context turns the recorder off when the job sets `setup_s`, and
    keeps the set-up's spans; the dataclass's own nan leaves it on."""
    from raytracer_tpu_torch.utils import trace

    trace.collect()
    trace.enable()
    try:
        ctx = spans.SetupEnds(cell=None, seed=1, seconds=0.0, trace=True, device="cpu",
                              start=0.0)
        with trace.span("build"):
            pass
        assert trace.span("x") is not trace.span("y")  # still on
        ctx.setup_s = 1.5
        assert set(ctx.setup_spans) == {"build"} and ctx.setup_s == 1.5
        assert trace.span("x") is trace.span("y")  # off
    finally:
        trace.disable()
        trace.collect()


def test_stretch_on_the_cpu_keeps_the_spans():
    """The program's recorder on the CPU: the stretch runs its items, keeps
    their spans and leaves the recorder off."""
    from raytracer_tpu_torch.utils import trace

    def item():
        with trace.span("step"):
            with trace.span("backward"):
                pass

    kept = spans.stretch(item, 2, False)
    assert kept["items"] == 2 and kept["by_name"]["step"]["n"] == 2
    assert kept["by_name"]["backward"]["n"] == 2 and len(kept["item_s"]) == 2
    assert "idle_ms" not in kept and trace.collect() == []
    assert trace.span("x") is trace.span("y")


def test_events_of_reads_a_profile():
    """The raw results of a CPU profile: the span's range and the
    operations inside it, with their ids."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("render/pack"):
            torch.ones(4).add_(1)
    events = spans.events_of(prof)
    pack = next(e for e in events if e.name == "render/pack")
    add = next(e for e in events if e.name == "aten::add_")
    assert pack.cpu and pack.annotation and not add.annotation
    assert pack.start <= add.start < add.end <= pack.end and add.corr > 0 and add.link == 0
    pieces = spans.innermost([(pack.start, pack.end, pack.name)])
    assert spans.label_at(pieces, add.start) == "render/pack"


def synthetic(cuda=True, render=True):
    rec = TraceRecord()
    if render:
        by_name = {"render/pack": {"n": 4, "host_ms": 8.0, "syncs": 2},
                   "render/fold": {"n": 4, "host_ms": 2.0, "device_ms": 6.0, "syncs": 0},
                   "render_image": {"n": 4, "host_ms": 40.0, "syncs": 12},
                   "to_u8": {"n": 4, "host_ms": 1.0, "syncs": 0}}
        trace = {"device_ops": {"render/fold": 688, "render/kernel": 4},
                 "idle_ms": {"render/pack": 3.0}}
        setup = {"scene/build": 0.01}
    else:
        by_name = {"step": {"n": 2, "host_ms": 2000.0, "syncs": 400},
                   "replay_forward": {"n": 2, "host_ms": 500.0, "syncs": 396},
                   "backward": {"n": 2, "host_ms": 1400.0, "syncs": 2}}
        trace = {"device_ops": {"backward": 10}, "idle_ms": {"replay_forward": 200.0,
                                                             "backward": 900.0}}
        setup = {"build": 6.5, "build/optimizer": 5.9}
    rec.extra["spans"] = {"cuda": cuda, "items": 4 if render else 2, "item_s": [],
                          "by_name": by_name, "setup": setup, **(trace if cuda else {})}
    return rec


def test_render_metrics_read_the_stretch():
    rec = synthetic()
    read = {m: metric_reader(m)(rec) for m in NEW if m.endswith(".render")}
    assert read == {"pack_ms.render": 2.0, "fold_ms.render": 1.5, "fold_ops.render": 172.0,
                    "host_syncs.render": 3.0}


def test_train_metrics_read_the_stretch():
    rec = synthetic(render=False)
    read = {m: metric_reader(m)(rec) for m in NEW if m.endswith(".train")}
    assert read == {"host_syncs.train": 200.0, "replay_idle_ms.train": 100.0,
                    "backward_idle_ms.train": 450.0, "step_build_s.train": 6.5}


@pytest.mark.parametrize("name", NEW)
def test_metrics_read_none_where_nothing_is(name):
    """No stretch (a program without the recorder), and on the CPU the
    counters and the device trace."""
    assert metric_reader(name)(TraceRecord()) is None
    cpu = synthetic(cuda=False, render=name.endswith(".render"))
    value = metric_reader(name)(cpu)
    if name in ("pack_ms.render", "step_build_s.train"):
        assert value is not None  # host times, which run.py leaves out on the CPU
    elif name != "fold_ms.render":
        assert value is None
