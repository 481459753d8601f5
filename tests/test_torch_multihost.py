"""Multi-process rendering through the port's launchers: the multi-host
script (raytracer_tpu_torch/scripts/run_multihost.py) as two gloo processes
on the CPU, the CLI's --shard under torchrun's environment, and the CLI's
--shard at one rank (tests/test_multihost.py's case, and the CLI's flags).
A two-rank image is the in-process sum of its ranks' partials bit for bit,
and agrees with the JAX package's non-regenerative render within JAX's own
limit."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from raytracer_tpu.render.driver import render_image as jax_render_image
from raytracer_tpu.render.postprocess import to_u8 as jax_to_u8
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.render.postprocess import to_u8
from raytracer_tpu_torch.scenes.registry import get_scene
from test_torch_sharding import free_port, in_process_regen

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def run_processes(argvs, envs):
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for argv, env in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    return outs


def clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT", "GROUP_RANK")}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def two_rank_png(name, **kw):
    scene, cam, st = get_scene(name, **kw)
    return to_u8(torch.from_numpy(in_process_regen(scene, cam, st, 2, 0))).numpy()


def test_two_process_script_render(tmp_path):
    out = str(tmp_path / "mh.png")
    coord = f"localhost:{free_port()}"
    argv = ["-m", "raytracer_tpu_torch.scripts.run_multihost", "--scene", "quads", "--spp", "8",
            "--width", "96", "--out", out, "--coordinator", coord, "--num-processes", "2"]
    outs = run_processes([argv + ["--process-id", str(r)] for r in (0, 1)], [clean_env()] * 2)
    assert "mesh: {'tiles': 2, 'samples': 1} over 2 ranks (gloo)" in outs[0]
    mh = np.asarray(Image.open(out).convert("RGB"))
    np.testing.assert_array_equal(mh, two_rank_png("quads", spp=8, width=96))
    # Statistical sanity against the JAX package's unsharded pass loop.
    scene, cam, st = jax_get_scene("quads", spp=8, width=96)
    ref = np.asarray(jax_to_u8(jax_render_image(scene, cam, st, seed=0, regenerative=False)))
    np.testing.assert_allclose(mh.astype(np.float32).mean((0, 1)) / 255.0,
                               ref.astype(np.float32).mean((0, 1)) / 255.0, atol=0.03)


def test_cli_shard_under_torchrun_environment(tmp_path):
    """Two ranks from RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT (what torchrun
    sets), --sample-parallel 2: rank 0 alone writes the image and prints
    the report, with the mesh and the backend."""
    out = str(tmp_path / "tr.png")
    port = str(free_port())
    argv = ["-m", "raytracer_tpu_torch.cli", "--shard", "--sample-parallel", "2", "--device",
            "cpu", "--scene", "cornell", "--width", "24", "--spp", "4", "--max-depth", "4",
            "--out", out]
    envs = [clean_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=port) for r in (0, 1)]
    outs = run_processes([argv, argv], envs)
    reports = [[json.loads(ln) for ln in o.splitlines() if ln.startswith("{")] for o in outs]
    assert len(reports[0]) == 1 and reports[1] == []
    rep = reports[0][0]
    assert rep["mesh"] == [1, 2] and rep["backend"] == "gloo" and rep["group_start_s"] > 0
    png = np.asarray(Image.open(out).convert("RGB"))
    np.testing.assert_array_equal(
        png, two_rank_png("cornell", width=24, spp=4, max_depth=4))


def test_sample_parallel_requires_shard(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--sample-parallel", "2", "--device", "cpu"])
    assert e.value.code == 2
    assert "--sample-parallel requires --shard" in capsys.readouterr().err


def test_shard_cli_world_of_one_is_the_plain_cli(tmp_path, capsys):
    """--shard run alone: a group of one rank on --device, the plain CLI's
    PNG byte for byte, the group closed after; with --checkpoint it saves
    and a rerun resumes from the finished file."""
    args = ["--device", "cpu", "--scene", "rand_spheres", "--width", "32", "--spp", "4",
            "--max-depth", "5"]
    plain = cli.main(args + ["--out", str(tmp_path / "plain.png")])
    shard = cli.main(args + ["--shard", "--out", str(tmp_path / "shard.png")])
    assert not torch.distributed.is_initialized()
    assert (tmp_path / "plain.png").read_bytes() == (tmp_path / "shard.png").read_bytes()
    assert shard["mesh"] == [1, 1] and shard["backend"] == "gloo"
    assert shard["group_start_s"] >= 0 and "mesh" not in plain
    assert shard["traced_segments"] == plain["traced_segments"]
    ck = ["--shard", "--checkpoint", str(tmp_path / "ck.npz")]
    cli.main(args + ck + ["--out", str(tmp_path / "ck1.png")])
    capsys.readouterr()
    cli.main(args + ck + ["--out", str(tmp_path / "ck2.png")])
    assert "resumed at 4/4 spp" in capsys.readouterr().out
    for name in ("ck1.png", "ck2.png"):
        assert (tmp_path / name).read_bytes() == (tmp_path / "plain.png").read_bytes()


def test_shard_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA request succeeds")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        cli.main(["--shard", "--width", "16", "--spp", "1", "--out", str(tmp_path / "x.png")])
    assert not torch.distributed.is_initialized()
