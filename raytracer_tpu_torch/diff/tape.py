"""Tape replay: the differentiable half of the tape-forward gradient (port of
raytracer_tpu/diff/tape.py:make_tape_intersect_fn).

A forward that needs no gradient records only the winning primitive of each
(bounce, lane), the (max_depth, N) int32 tape. Every discrete decision of a
path (which primitive, which dielectric branch, metal absorption, the end)
is a function of that tape and the path's uniforms, so the replay does not
search primitives: it looks the winner up and recomputes its t with
autograd (geometry.intersect.winner_t_diff), O(1) per lane-bounce.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.geometry.intersect import DEFAULT_T_MIN, quad_derived, winner_t_diff


def make_tape_intersect_fn(tape, t_min: float = DEFAULT_T_MIN):
    """Intersect hook of integrator.wavefront.trace that replays `tape`
    (max_depth, N): column L is lane L of the traced batch, row b its winner
    at bounce b (-1 for a miss or a dead lane). Returns (t with autograd,
    +inf on a miss; prim)."""

    def fn(scene, origin, direction, bounce, lanes):
        prim = tape[bounce][lanes]
        hit = prim >= 0
        t_nd = torch.where(hit, 1.0, torch.inf)
        t = winner_t_diff(
            scene, quad_derived(scene), origin, direction,
            torch.clamp(prim, min=0), t_nd, t_min,
        )
        return t, prim

    return fn
