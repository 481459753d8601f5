"""Quads and rays built to reach every branch of the closest-hit quad test
(csrc/closest_hit.cuh:quad_candidates_range), and a NumPy reference of
that test in early-out form, shared by the port's CPU tests and its `cuda`
test of kernel 1 (tests/test_torch_kernels.py) and by chip_smoke.py's
phase 2. Imports neither jax nor torch."""

import numpy as np

F32 = np.float32
T_MIN = F32(1e-3)
QUAD_DENOM_EPS = F32(1e-8)


def quad_table(quads) -> np.ndarray:
    """(Q, 12) float32 rows [n, n.Q, av, bv, Q.av, Q.bv] of (Q, u, v)
    triples (geometry/intersect.py:quad_derived in float64)."""
    rows = []
    for q, u, v in quads:
        q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
        n_raw = np.cross(u, v)
        nn = n_raw @ n_raw
        w = n_raw / nn
        n = n_raw / np.sqrt(nn)
        av, bv = np.cross(v, w), np.cross(w, u)
        rows.append(np.concatenate([n, [n @ q], av, bv, [q @ av, q @ bv]]))
    return np.asarray(rows, F32)


def adversarial_quad_rays():
    """(quad table (Q, 12), origins (N, 3), directions (N, 3)) float32.

    Unit quads on the planes y = 0 (normal -y; a second one overlapping
    half of it, so hits there tie in t), y = 2 (normal +y) and x = 3, a
    tilted quad, and groups of small quads behind the rays, so that whole
    groups of four face away. Rays: origins on a plane (num = +0 and -0),
    |d.n| exactly QUAD_DENOM_EPS and one float32 step below it, t exactly
    T_MIN and one step either side, both sides of each plane (back-facing
    normals), in-quad coordinates of exactly 0 and 1, NaN and infinite
    directions, tied hits, and random rays through the cluster."""
    quads = [((0, 0, 0), (1, 0, 0), (0, 0, 1)),      # y = 0, normal -y
             ((0.5, 0, 0), (1, 0, 0), (0, 0, 1)),    # overlaps it: ties
             ((0, 2, 0), (0, 0, 1), (1, 0, 0)),      # y = 2, normal +y
             ((3, 0, 0), (0, 1, 0), (0, 0, 1)),      # x = 3
             ((-1, 0.5, -1), (0.8, 0.3, 0.1), (-0.2, 0.4, 0.9))]  # tilted
    quads += [((gx, -5.0 - gz, 4.0), (0.4, 0, 0), (0, 0.4, 0.1))  # behind the rays
              for gx in range(4) for gz in range(3)]
    table = quad_table(quads)
    rng = np.random.default_rng(5)
    o, d = [], []

    def ray(orig, dirn):
        o.append(np.asarray(orig, F32))
        d.append(np.asarray(dirn, F32))

    for x in (0.0, 0.25, 0.5, 0.75, 1.0, np.nextafter(F32(1), F32(2)),
              np.nextafter(F32(0), F32(-1))):  # in-quad coordinate 0 and 1, and just off
        for z in (0.0, 0.5, 1.0):
            ray((x, 1.0, z), (0, -1, 0))   # down onto y = 0 from above
            ray((x, -1.0, z), (0, 1, 0))   # up onto it from below (and on to y = 2)
            ray((x, 3.0, z), (0, -2, 0))   # |d| = 2
    for y0 in (0.0, -0.0):  # origin on the plane y = 0: num = +-0
        for dy in (-1.0, 1.0, 0.5):
            ray((0.5, y0, 0.5), (0.1, dy, 0.2))
    eps_lo = np.nextafter(QUAD_DENOM_EPS, F32(0))
    for dn in (QUAD_DENOM_EPS, eps_lo, -QUAD_DENOM_EPS, -eps_lo, F32(0)):  # |d.n| at the eps
        for oy in (1e-9, -1e-9, 1.0):
            ray((0.5, oy, 0.5), (0.5, -dn, 0.001))
    for h in (T_MIN, np.nextafter(T_MIN, F32(1)), np.nextafter(T_MIN, F32(0))):  # t at T_MIN
        ray((0.5, h, 0.5), (0, -1, 0))
        ray((0.5, -h, 0.5), (0, 1, 0))
        ray((0.5, 2 + h, 0.5), (0, -1, 0))
    for dirn in ((np.nan, -1, 0), (0, np.nan, 0), (np.inf, -1, 0), (0, -np.inf, 0)):
        ray((0.5, 1.0, 0.5), dirn)
    ray((0.5, np.nan, 0.5), (0, -1, 0))
    for _ in range(400):  # random rays through and around the quads, both ways
        orig = rng.uniform((-2, -3, -2), (4, 4, 2))
        tgt = rng.uniform((-1, -1, -1), (3.5, 2.5, 1.5))
        ray(orig, tgt - orig)
        ray(orig, orig - tgt)
    return table, np.stack(o).astype(F32), np.stack(d).astype(F32)


def early_out_quad_hits(table, o, d):
    """NumPy float32 reference of the quad test in early-out form, over the
    whole table, row by row in the kernel's order (the loop of
    utils/time_kernels.py's `quadearly` variant, and the work that
    utils/bounds.py counts as needed): a row whose plane does not face the
    ray (|d.n| < QUAD_DENOM_EPS, or num and d.n not nonzero and of one
    sign) is skipped before its division, one whose t is not past T_MIN or
    whose t * a does not beat the running best before its in-quad test.
    Returns (t (N,), row (N,) int, -1 on a miss, divisions
    (N,), in-quad tests (N,)): the winner's t rescaled as the twin rescales
    it, and the rows that reach each step."""
    n = o.shape[0]
    t_out = np.full(n, np.inf, F32)
    p_out = np.full(n, -1, np.int64)
    steps = np.zeros((2, n), np.int64)
    with np.errstate(all="ignore"):
        for i in range(n):
            ox, oy, oz = o[i]
            dx, dy, dz = d[i]
            a = dx * dx + dy * dy + dz * dz
            t_best, p_best = F32(np.inf), -1
            for qi, row in enumerate(table):
                d_n = dx * row[0] + dy * row[1] + dz * row[2]
                o_n = ox * row[0] + oy * row[1] + oz * row[2]
                num = row[3] - o_n
                if not (abs(d_n) >= QUAD_DENOM_EPS
                        and ((d_n > 0) if num > 0 else (num < 0 and d_n < 0))):
                    continue
                t = num / d_n
                t_cand = t * a
                steps[0, i] += 1
                if not (t > T_MIN) or not (t_cand < t_best):
                    continue
                steps[1, i] += 1
                alpha = (ox * row[4] + oy * row[5] + oz * row[6]) + t * (
                    dx * row[4] + dy * row[5] + dz * row[6]) - row[10]
                beta = (ox * row[7] + oy * row[8] + oz * row[9]) + t * (
                    dx * row[7] + dy * row[8] + dz * row[9]) - row[11]
                if 0 <= alpha <= 1 and 0 <= beta <= 1:
                    t_best, p_best = t_cand, qi
            t_out[i] = t_best * (F32(1.0) / a)
            p_out[i] = p_best
    return t_out, p_out, steps[0], steps[1]
