"""The port's CLI flags on the CPU (raytracer_tpu/cli.py's `--profile`,
`--memory-profile` and `--checkpoint`): a torch.profiler trace under
out/trace holding the program's spans, the memory report's refusal off the card, and a checkpointed
render that resumes and writes the plain render's PNG; and the memory
helpers' CPU results."""

import json

import numpy as np
import torch

from raytracer_tpu_torch import cli
from raytracer_tpu_torch.utils.metrics import device_memory_stats, save_memory_profile

torch.set_num_threads(1)

ARGS = ["--device", "cpu", "--scene", "cornell", "--width", "16", "--spp", "4",
        "--max-depth", "3"]


def test_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    report = cli.main(ARGS + ["--out", "a.png", "--profile"])
    traces = list((tmp_path / "out" / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # The program's spans (utils/trace.py), which --profile turns on.
    names = {e.get("name") for e in events}
    assert {"render_image", "render/pack", "render/chunk", "render/kernel", "render/fold",
            "render/mean", "to_u8"} <= names
    assert report["spp"] == 4 and (tmp_path / "a.png").exists()


def test_memory_profile_unavailable_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    report = cli.main(ARGS + ["--out", "a.png", "--memory-profile", "mem.json"])
    assert "memory profile unavailable on this backend" in capsys.readouterr().out
    assert not (tmp_path / "mem.json").exists()
    assert "peak_hbm_mb" not in report
    assert device_memory_stats("cpu") == {}
    assert save_memory_profile(str(tmp_path / "m.json"), "cpu") is False


def test_checkpoint_resumes_and_writes_the_plain_png(tmp_path, monkeypatch, capsys):
    """`--checkpoint` run twice: the second run resumes at the full spp and
    writes the same PNG; both are the plain CLI render's PNG, byte for
    byte (the default chunk is render_image's)."""
    monkeypatch.chdir(tmp_path)
    cli.main(ARGS + ["--out", "plain.png"])
    cli.main(ARGS + ["--out", "a.png", "--checkpoint", "ck.npz"])
    first = capsys.readouterr().out
    assert "resumed at" not in first and (tmp_path / "ck.npz").exists()
    cli.main(ARGS + ["--out", "b.png", "--checkpoint", "ck.npz"])
    assert "resumed at 4/4 spp" in capsys.readouterr().out
    plain = (tmp_path / "plain.png").read_bytes()
    assert (tmp_path / "a.png").read_bytes() == plain
    assert (tmp_path / "b.png").read_bytes() == plain
    with np.load(tmp_path / "ck.npz") as z:
        assert int(z["done_spp"]) == 4 and z["acc"].shape == (16, 16, 3)
