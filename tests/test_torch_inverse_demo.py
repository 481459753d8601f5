"""The port's inverse-rendering demo (raytracer_tpu_torch/scripts/
inverse_render_demo.py) on the CPU at a tiny size: stage 3, the blocker
recovered from its shadow alone, moves toward its true position."""

import torch

from raytracer_tpu_torch.scripts import inverse_render_demo as demo

torch.set_num_threads(1)


def test_shadow_stage_moves_the_blocker_toward_its_target(tmp_path):
    """Two Adam steps at 24x24, 8 spp, with two target renders: the
    blocker's x goes up from its start (-0.25) toward the target (0.35)
    each step and does not pass it, and the stage writes its images.
    Only the shadow term carries this axis (tests/test_torch_shadow_
    edge.py), so the move is its work."""
    out = demo.stage_shadow(str(tmp_path), "cpu", size=24, spp=8, steps=2, fd_seeds=0,
                            target_seeds=2)
    bx = [demo.START_BX] + out["bx_history"]
    assert all(a < b for a, b in zip(bx, bx[1:])), bx
    assert bx[-1] < demo.TARGET_BX
    assert out["n_prims"] == 17 and out["init_bx"] == demo.START_BX
    assert (tmp_path / "shadow_target.png").exists()
    assert (tmp_path / "shadow_recovered.png").exists()
