"""What a benchmark run loads: no module whose top-level name, compared
whole, is jax, jaxlib, flax or raytracer_tpu; and the reference nothing of
the program."""

import ast
import subprocess
import sys

from benchmark import harness

REFERENCE = harness.ROOT / "reference"


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=harness.REPO, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_benchmark_modules_load_no_jax():
    readers = sorted(p.stem for p in (harness.ROOT / "metrics").glob("*.py")
                     if p.stem != "__init__")
    code = "\n".join([
        "import benchmark.run, benchmark.control, benchmark.jobs.render, benchmark.jobs.train",
        "import benchmark.reference.tracer, benchmark.reference.train",
        "import benchmark.reference.compare",
        *[f"benchmark.run.metric_reader({r!r})" for r in readers],
        # What a run imports of the program, at its entry points.
        "import raytracer_tpu_torch.render.driver, raytracer_tpu_torch.render.postprocess",
        "import raytracer_tpu_torch.diff.grad, raytracer_tpu_torch.geometry.scene",
        "import raytracer_tpu_torch.core.camera, raytracer_tpu_torch.utils.launches",
        "import raytracer_tpu_torch.utils.metrics",
    ])
    loaded = loaded_after(code)
    assert "raytracer_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "raytracer_tpu"}


def test_reference_imports_nothing_of_the_program():
    loaded = loaded_after("import benchmark.reference.tracer, benchmark.reference.train, "
                          "benchmark.reference.compare, benchmark.reference.rng")
    assert not loaded & {"raytracer_tpu_torch", "raytracer_tpu", "jax", "jaxlib"}
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("raytracer_tpu_torch", "raytracer_tpu",
                                                  "jax"), (path.name, name)
