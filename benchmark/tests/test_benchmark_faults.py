"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (`--device cpu`) and everything
else of a run is driven, once for each fault its cell can have."""

import json

import pytest
import torch

from benchmark import run

SEED = 2**31 + 99


def result(capsys, cell: str) -> dict:
    capsys.readouterr()
    assert run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                     "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_runs_are_correct(capsys):
    assert result(capsys, "rand_spheres.render")["correct"] is True
    assert result(capsys, "rand_spheres.train")["correct"] is True


@pytest.fixture
def driver(monkeypatch):
    from raytracer_tpu_torch.render import driver

    return driver, driver.render_image, monkeypatch


def test_render_half_the_samples(capsys, driver):
    module, render_image, mp = driver

    def half(scene, cam, settings, **kw):
        return render_image(scene, cam, settings._replace(
            samples_per_pixel=settings.samples_per_pixel // 2), **kw)

    mp.setattr(module, "render_image", half)
    assert result(capsys, "rand_spheres.render")["correct"] is False


def test_render_image_altered(capsys, driver):
    module, render_image, mp = driver
    mp.setattr(module, "render_image", lambda *a, **kw: render_image(*a, **kw) * 1.01)
    out = result(capsys, "cornell.render")
    assert out["correct"] is False and out["checks"]["pixel_gap"]["value"] > 1e-3


def test_render_u8_altered(capsys, monkeypatch):
    from raytracer_tpu_torch.render import postprocess

    to_u8 = postprocess.to_u8

    def altered(img):
        u8 = to_u8(img).clone()
        u8[0, 0, 0] ^= 4
        return u8

    monkeypatch.setattr(postprocess, "to_u8", altered)
    out = result(capsys, "rand_spheres.preview")
    assert out["correct"] is False and out["checks"]["u8_off"]["value"] >= 1


@pytest.fixture
def inverse(monkeypatch):
    from raytracer_tpu_torch.diff import grad

    return grad, grad.make_inverse_renderer, monkeypatch


def test_train_state_unchanged(capsys, inverse):
    module, make, mp = inverse

    def frozen(*a, **kw):
        params, optimizer, step = make(*a, **kw)

        def still(seed, timings=None):
            saved = {k: v.detach().clone() for k, v in params.items()}
            loss = step(seed, timings)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            optimizer.state.clear()
            return loss

        return params, optimizer, still

    mp.setattr(module, "make_inverse_renderer", frozen)
    assert result(capsys, "rand_spheres.train")["correct"] is False


def test_train_half_the_samples(capsys, inverse):
    module, make, mp = inverse
    mp.setattr(module, "make_inverse_renderer", lambda *a, samples_per_pass, **kw: make(
        *a, samples_per_pass=samples_per_pass // 2, **kw))
    assert result(capsys, "rand_spheres.train")["correct"] is False


def test_train_loss_altered(capsys, inverse):
    module, make, mp = inverse

    def altered(*a, **kw):
        params, optimizer, step = make(*a, **kw)
        return params, optimizer, lambda seed, timings=None: step(seed, timings) * 1.01

    mp.setattr(module, "make_inverse_renderer", altered)
    assert result(capsys, "rand_spheres.train")["correct"] is False


@pytest.mark.parametrize("fault", ["reversed", "betas"])
def test_train_update_faults(capsys, fault):
    from benchmark import control

    with control.program_fault(fault):
        out = result(capsys, "rand_spheres.train")
    assert out["correct"] is False and out["checks"]["update_gap"]["value"] > 0.1
