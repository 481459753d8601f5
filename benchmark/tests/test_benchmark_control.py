"""The control and the planted fault of `correct`, at a size a test run
holds: the reference in bfloat16 put in the program's place fails a
cell's numbers, as does a step that leaves out half its samples. On the
card, `python3 -m benchmark.control` reads them at the cells' own sizes."""

import math

import pytest

from benchmark import control, harness


def fails(reading: dict, limits: dict) -> bool:
    return any(not math.isfinite(reading[k]) or reading[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", ["rand_spheres.render", "cornell.render", "rand_spheres.preview"])
def test_render_control_fails(cell):
    c = harness.Cell.load(cell, cpu=True)
    for r in control.render_control(c, [1, 2], device="cpu"):
        assert r["pixel_gap"] > c.check["limits"]["pixel_gap"]


def test_train_control_and_fault_fail():
    c = harness.Cell.load("rand_spheres.train", cpu=True)
    limits = c.check["limits"]
    assert all(fails(r, limits) for r in control.train_readings(c, [1], device="cpu"))
    assert all(fails(r, limits) for r in control.train_readings(c, [1], device="cpu",
                                                                 drop_half=True))


def test_program_readings_pass():
    c = harness.Cell.load("rand_spheres.train", cpu=True)
    for r in control.program_readings("rand_spheres.train", [4], device="cpu"):
        assert not fails(r, c.check["limits"])
