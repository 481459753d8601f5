"""The port's benchmark (raytracer_tpu_torch/bench.py) on the CPU at tiny
shapes: every row runs and reports the JAX bench's keys for it, the row
names are the JAX bench's (read from its text; nothing imports it), a
failing row leaves the others and fails the run, the last line's schema,
no CPU fallback for a CUDA request, and no jax import."""

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch import bench
from raytracer_tpu_torch.scenes.registry import get_scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RENDER_KEYS = {"traced_mrays_per_s", "camera_mrays_per_s", "avg_segments_per_camera_ray",
               "occupancy", "wall_s", "spp", "walls_s"}  # bench.py:_measure's `out`
# The other rows' keys in the JAX bench (bench.py:236-258, 308-329, 366-375):
# grad_depth50's "bucketed" keys are left out by design.
JAX_KEYS = {
    "grad": {"step_wall_s", "camera_mrays_per_s", "fixed_depth_lane_bounces_mrays_per_s", "size",
             "spp", "max_depth", "walls_s", "bucketed_kernel_step_wall_s",
             "bucketed_kernel_camera_mrays_per_s", "bucketed_kernel_walls_s"},
    "grad_depth50": {"size", "spp", "max_depth", "scan_step_wall_s", "scan_walls_s",
                     "bucketed_kernel_step_wall_s", "bucketed_kernel_walls_s"},
    "grad_full": {"size", "spp", "max_depth", "boundary", "shadow_edges", "step_wall_s",
                  "walls_s"},
}
DENSE_ROWS = ("low_spp", "perlin", "simple_light", "earth", "earth_bilinear", "earth_hires_tex",
              "cornell", "quads", "one_weekend_1200x800")
CLUSTERED_ROWS = ("large_10k", "large_50k", "quad_field_8k")
# Tiny shapes of each kind of row.
TINY = {"grad": dict(width=16, spp=1, max_depth=2),
        "grad_depth50": dict(width=16, spp=1, max_depth=2),
        "grad_full": dict(width=8, spp=1, max_depth=1)}
TINY_RENDER = dict(width=16, spp=2)
TINY_ARGS = ["--device", "cpu", "--width", "16", "--spp", "2", "--repeats", "1"]


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(bench.ROWS))
def test_every_row_reports_the_jax_keys(name, monkeypatch):
    if name == "grad_full":
        # The edge terms' CPU closest hit over rand_spheres' 488 spheres takes
        # minutes here; simple_light (five primitives, an emitter) keeps both terms.
        monkeypatch.setattr(bench, "get_scene", lambda scene, **kw: get_scene("simple_light", **kw))
    row = bench.ROWS[name]("cpu", 2, **TINY.get(name, TINY_RENDER))
    assert JAX_KEYS.get(name, RENDER_KEYS) <= set(row), sorted(row)
    assert row["finite"]
    assert bench.row_faults(name, row, on_card=False) == []
    # The CPU takes the plain twins: no kernel launched, no device metric.
    kernels = {k: v for k, v in row.items() if k.endswith("kernels")}
    assert kernels and all(c == 0 for counts in kernels.values() for c in counts.values())
    assert "peak_hbm_mb" not in row
    walls = [v for k, v in row.items() if k.endswith("walls_s")]
    assert walls and all(len(w) == 2 and min(w) > 0 for w in walls)
    if name in JAX_KEYS:
        return
    assert row["path"] == "persistent" and row["spp"] == 2 and row["size"][0] == 16
    assert row["wall_s"] == sorted(row["walls_s"])[0]  # median_low of two runs
    assert row["traced_segments"] >= row["camera_rays"] == 16 * row["size"][1] * 2
    assert 0 < row["occupancy"] <= 1 and row["chunks"] == 1
    if name in CLUSTERED_ROWS:
        assert row["bvh_builder"] and row["cluster_s"] > 0 and "flops_per_segment" not in row
    else:
        assert name in DENSE_ROWS and row["flops_per_segment"] > 0 and "cluster_s" not in row


def jax_bench_rows() -> set:
    """The detail rows of the root bench.py, read from its text."""
    src = (REPO / "bench.py").read_text()
    rows = set(re.findall(r'detail\["(\w+)"\] = ', src))
    loop = re.search(r"for extra in \(([^)]*)\):", src).group(1)
    rows |= set(re.findall(r'"(\w+)"', loop))
    return rows - {"size", "device"}  # the headline's own keys


def test_row_names_are_the_jax_bench_rows():
    rows = jax_bench_rows()
    assert len(rows) == 15
    assert set(bench.ROWS) == rows


def test_row_shapes_are_the_jax_bench_shapes():
    """Each row's default shape, as the JAX bench builds it (bench.py:421-560)."""
    shape = {n: fn.keywords for n, fn in bench.ROWS.items() if isinstance(fn, functools.partial)}
    assert shape["low_spp"] == dict(scene="rand_spheres", width=400, spp=64)
    assert shape["earth_hires_tex"] == dict(scene="earth", spp=100, tex_height=512,
                                            tex_width=1024)
    assert shape["earth_bilinear"] == dict(scene="earth", width=400, spp=500, bilinear=True)
    assert shape["cornell"] == dict(scene="cornell", spp=200)
    assert shape["large_50k"] == dict(scene="rand_spheres_large", width=400, spp=64,
                                      n_spheres=50000)
    assert shape["one_weekend_1200x800"] == dict(scene="one_weekend_final", spp=125)
    assert set(bench.ROWS) - set(shape) == {"grad", "grad_depth50", "grad_full"}


@pytest.fixture
def tiny_rows(monkeypatch):
    """Two render rows at tiny shapes."""
    for name in ("low_spp", "cornell"):
        monkeypatch.setitem(bench.ROWS, name,
                            functools.partial(bench.ROWS[name], width=16, spp=2))


def test_last_line_schema(tiny_rows, capsys):
    assert bench.main(TINY_ARGS + ["--rows", "low_spp,cornell"]) == 0
    out = last_json(capsys.readouterr().out)
    assert set(out) >= {"metric", "value", "unit", "vs_baseline", "detail", "device", "ok"}
    assert out["metric"] == "traced_rays_per_s_randspheres" and out["unit"] == "Mrays/s"
    assert out["ok"] is True and out["faults"] == []
    assert out["device"] == {"name": "cpu", "power_limit_w": None}
    detail = out["detail"]
    assert out["value"] == detail["traced_mrays_per_s"] > 0
    assert out["vs_baseline"] == pytest.approx(detail["camera_mrays_per_s"] / 0.9)
    assert detail["size"] == [16, 9] and detail["spp"] == 2
    assert {"low_spp", "cornell"} <= set(detail) and "grad" not in detail
    assert detail["cornell"]["size"] == [16, 16]
    assert detail["builds"]["bvh_builder_s"] >= 0 and "kernels_s" not in detail["builds"]


def test_a_failing_row_keeps_the_others_and_fails_the_run(tiny_rows, monkeypatch, capsys):
    def broken(device, repeats, **shape):
        raise RuntimeError("row broke")

    monkeypatch.setitem(bench.ROWS, "cornell", broken)
    assert bench.main(TINY_ARGS + ["--rows", "cornell,low_spp"]) != 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["ok"] is False
    assert "row broke" in out["detail"]["cornell"]["error"]
    assert "error" not in out["detail"]["low_spp"] and out["detail"]["low_spp"]["wall_s"] > 0
    assert out["faults"] == ["cornell: RuntimeError: row broke"]
    # Each row also printed its own line as it finished.
    assert [json.loads(line)["row"] for line in lines[1:-1]] == ["headline", "cornell", "low_spp"]


@pytest.mark.parametrize("fault", ["not_finite", "few_segments", "no_kernel"])
def test_row_faults(fault):
    good = dict(finite=True, traced_segments=10, camera_rays=8,
                kernels=dict(persistent_render=1, closest_hit=0))
    assert bench.row_faults("low_spp", good, on_card=True) == []
    row = dict(good, kernels=dict(good["kernels"]))
    if fault == "not_finite":
        row["finite"] = False
    elif fault == "few_segments":
        row["traced_segments"] = 7
    else:
        row["kernels"]["persistent_render"] = 0
    assert len(bench.row_faults("low_spp", row, on_card=True)) == 1
    # Launch counts are held on the card only.
    assert bool(bench.row_faults("low_spp", row, on_card=False)) == (fault != "no_kernel")


def test_gradient_rows_need_their_kernels_on_the_card():
    counts = dict(closest_hit=3, persistent_tape=1)
    none = dict(closest_hit=0, persistent_tape=0)
    assert bench.row_faults("grad_full", dict(finite=True, kernels=counts), True) == []
    assert len(bench.row_faults("grad_full", dict(finite=True, kernels=none), True)) == 2
    row = dict(finite=True, scan_kernels=counts, bucketed_kernel_kernels=dict(counts,
                                                                              persistent_tape=0))
    assert bench.row_faults("grad_depth50", row, True) == [
        f"grad_depth50: bucketed_kernel_kernels shows no persistent_tape launch "
        f"({row['bucketed_kernel_kernels']})"]


def test_unknown_row_is_refused():
    with pytest.raises(SystemExit):
        bench.main(TINY_ARGS + ["--rows", "low_spp,nope"])


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_cuda_without_a_card_raises_before_any_row(no_card, monkeypatch, capsys):
    def ran(*a, **k):
        raise AssertionError("a row ran")

    monkeypatch.setattr(bench, "render_row", ran)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--device", "cuda", "--repeats", "1", "--rows", ""])
    assert capsys.readouterr().out == ""


def test_new_entry_points_import_no_jax():
    code = (
        "import sys\n"
        "import raytracer_tpu_torch.bench, raytracer_tpu_torch.scripts.check_persistent\n"
        "import raytracer_tpu_torch.utils.launches\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'raytracer_tpu' or m.startswith('raytracer_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
