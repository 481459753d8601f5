"""The tape replay and its adjoint as one hand-written forward and reverse
sweep over each lane's whole path (`csrc/replay_kernel.cu`).

The bucketed step (diff/bucketed.py) replays the lanes of its tape forward
to differentiate sum(radiance * cotangent) in the scene tables. Its eager
replay (integrator/wavefront.py:trace with the tape's intersect hook) runs
about 330 PyTorch operations a bounce, 410 more in autograd's backward and
a host sync at every bounce's compaction. Here every lane's path is fixed
before it starts (the winners from the tape, the uniforms from the counter
hash keyed by the sample id, its depth bound from the tape), so one thread
traces a lane to its end and another sweeps it back, with no compaction, no
sync and no autograd graph:

* `ReplayPath`, an autograd Function: radiance (L, 3) of the lanes from
  the primitive table (P, 16) (materials/packed.py), the intersection
  table (P, 4) (`geom_table`: sphere centre and radius, quad normal and
  offset), the first rays o0, d0 (L, 3) (core/camera.py:camera_rays, so a
  trainable camera keeps its gradient through autograd) and the flat
  background (3,). Its backward writes one cotangent row a lane-bounce
  (the table's 16 columns, its spare columns 12-15 carrying the
  intersection table's) and sums them into the tables with
  ops/gather_kernel.py:gather_backward (fixed order, no float atomics: a
  step's gradient is bit-identical from run to run).
* CUDA tensors launch the kernels (`replay_forward`, `replay_adjoint`);
  CPU tensors take their plain twins, `replay_forward_plain` and
  `replay_adjoint_plain`: PyTorch that vectorises over lanes one bounce at
  a time and writes the kernels' arithmetic out formula by formula, with
  no autograd. They are the kernels' spec and equal them bit for bit on
  the card; the CPU tests hold them against autograd of the eager replay.
* `replay_kernel_reason(scene)`: why a scene keeps the eager replay (noise
  and image textures, whose shading the adjoint does not cover), None where
  the kernels serve it, as ops/persistent_kernel.py:unsupported_reason
  decides kernel 3's forward.

Scratch: each lane owns `depth` consecutive rows (its depth bound from
diff/bucketed.py:lane_depths), laid out by an exclusive prefix sum of the
depths (`scratch_layout`, whose total is the replay's one host sync). The
forward stores each lane-bounce's origin, direction and throughput there
(9 floats) and the adjoint recomputes the bounce from them.

Launch counters (utils/launches.py): `LAUNCHES` (`replay_path`) and
`LAUNCHES_ADJOINT` (`replay_adjoint`), one a launch; twin calls count
nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from raytracer_tpu_torch.core.sampling import TWO_PI
from raytracer_tpu_torch.materials.materials import NEAR_ZERO
from raytracer_tpu_torch.materials.packed import N_COLS
from raytracer_tpu_torch.ops import ctr_rng, gather_kernel
from raytracer_tpu_torch.ops.intersect_kernel import (
    QUAD_DENOM_EPS,
    T_MIN,
    check_float4_rows,
    check_tensor,
)

# Floats a lane-bounce of scratch: origin, direction, throughput.
STATE_COLS = 9
# Columns of a lane-bounce's cotangent row: the primitive table's.
ROW_COLS = N_COLS
# The row's columns that carry the intersection table's cotangent (the
# primitive table leaves them unused), and the table's columns that take no
# gradient (the material type, 1 / checker scale, the pad).
GEOM_COLS = slice(12, 16)
TABLE_NO_GRAD_COLS = (4, 12, 13, 14, 15)
# Floats a lane of the adjoint's per-lane output: the cotangents of o0, d0
# and the flat background.
LANE_COLS = 9
# materials.py:_dielectric_lr's clamp of the reflect probability.
LR_P_LO = 1e-4
LR_P_HI = 1.0 - 1e-4

# Threads per block of both kernels (one thread a lane).
THREADS = 128

# CUDA launches of the forward and of the adjoint (plain-twin calls do not
# count).
LAUNCHES = 0
LAUNCHES_ADJOINT = 0


def replay_kernel_reason(scene) -> str | None:
    """Why the replay kernels cannot replay `scene`; None if they can. The
    adjoint covers solid and checker colours; scenes with noise or image
    textures (the scenes materials/packed.py:texture_tables builds a table
    for) keep the eager replay with autograd (diff/bucketed.py:
    replay_loss), as ops/persistent_kernel.py:unsupported_reason sends some
    scenes off kernel 3's forward."""
    if scene.has_noise or scene.has_image:
        return ("noise and image textures are shaded by materials/textures.py, whose "
                "derivative the replay's adjoint does not carry")
    return None


def geom_table(scene, qd):
    """(P, 4) intersection table, spheres then quads: centre and radius, or
    unit normal and offset n.Q (`qd` is geometry.intersect.quad_derived);
    differentiable in them."""
    return torch.cat([torch.cat([scene.sph_center, scene.sph_radius[:, None]], 1),
                      torch.cat([qd.normal, qd.d[:, None]], 1)])


def scratch_layout(depth):
    """(offsets (L,) int64, rows): lane l owns scratch rows [offsets[l],
    offsets[l] + depth[l]), an exclusive prefix sum of the depths. Reading
    the total is a host sync."""
    ends = torch.cumsum(depth.to(torch.int64), 0)
    rows = int(ends[-1]) if ends.numel() else 0
    return ends - depth, rows


# ---- the plain twins: three-vectors as (x, y, z) tuples of (A,) tensors ----


def _vec(t):
    return t[:, 0], t[:, 1], t[:, 2]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _map(fn, *vs):
    return tuple(fn(*c) for c in zip(*vs))


def _sel(mask, a, b):
    """Where `mask`, a, else b: the kernels' `if`, taken lane by lane."""
    if isinstance(a, tuple):
        return tuple(torch.where(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask, a, b)


class _Bounce:
    """Every forward quantity of one bounce, for every lane (those of
    branches a lane does not take are garbage, never selected)."""


def _forward_bounce(table, geom, ns: int, prim, o, d, u):
    """The kernels' `forward_bounce`, vectorised: the winner's t (winner_t_diff's
    formulas) and the shading (resolve_and_shade's arithmetic) of the ray
    (o, d) at the tape's winners `prim` (-1 a miss), under uniforms u (A, 3)."""
    f = _Bounce()
    hit_tape = prim >= 0
    p = prim.clamp(min=0).long()
    f.quad = prim >= ns
    gr = geom[p]
    # winner t, sphere
    f.oc = (o[0] - gr[:, 0], o[1] - gr[:, 1], o[2] - gr[:, 2])
    f.r = gr[:, 3]
    f.a_t = _dot(d, d)
    f.hb = _dot(d, f.oc)
    f.cq = _dot(f.oc, f.oc) - f.r * f.r
    f.disc = f.hb * f.hb - f.a_t * f.cq
    f.disc_ok = f.disc > 0.0
    f.sq = torch.where(f.disc_ok, torch.sqrt(f.disc), 0.0)
    f.inv_a = 1.0 / f.a_t
    t0 = (-f.hb - f.sq) * f.inv_a
    t1 = (-f.hb + f.sq) * f.inv_a
    f.first = t0 > T_MIN
    f.num = torch.where(f.first, -f.hb - f.sq, -f.hb + f.sq)
    t_s = torch.where(f.first, t0, t1)
    # winner t, quad
    f.gq = _vec(gr)
    dn = _dot(d, f.gq)
    f.denom_ok = dn.abs() >= QUAD_DENOM_EPS
    f.safe = torch.where(f.denom_ok, dn, 1.0)
    f.tq = (gr[:, 3] - _dot(o, f.gq)) / f.safe
    f.t = torch.where(hit_tape, torch.where(f.quad, f.tq, t_s), math.inf)
    f.hit = hit_tape & torch.isfinite(f.t)
    f.prim = torch.where(f.hit, prim, 0)

    row = table[f.prim.long()]
    f.g = _vec(row)
    f.g3 = row[:, 3]
    f.mtype = row[:, 4].to(torch.int32)
    f.prm = row[:, 5]
    its = row[:, 12]
    t = f.t
    f.pt = _map(lambda oi, di: oi + t * di, o, d)
    f.s = _map(lambda pi, gi: (pi - gi) * f.g3, f.pt, f.g)
    f.s_len = torch.sqrt(f.s[0] * f.s[0] + f.s[1] * f.s[1] + f.s[2] * f.s[2] + 1e-20)
    f.su = _map(lambda si: si / f.s_len, f.s)
    out = _sel(f.quad, f.g, f.su)
    f.front = _dot(d, out) < 0.0
    f.sgn = torch.where(f.front, 1.0, -1.0)
    f.n = _map(lambda x: x * f.sgn, out)
    cpar = sum(torch.floor(pi * its).to(torch.int32) for pi in f.pt)
    f.use_c1 = (its > 0.0) & ((cpar & 1) != 0)
    f.tex = _sel(f.use_c1, _vec(row[:, 9:12]), _vec(row[:, 6:9]))
    f.light = f.mtype == 3
    f.lamb = f.mtype == 0
    f.metal = f.mtype == 1
    f.diel = ~(f.light | f.lamb | f.metal)

    sz = 1.0 - 2.0 * u[:, 0]
    sphi = TWO_PI * u[:, 1]
    sr = torch.sqrt(torch.clamp(1.0 - sz * sz, min=0.0))
    f.ss = (sr * torch.cos(sphi), sr * torch.sin(sphi), sz)
    f.a = _dot(d, d)
    f.sqa = torch.sqrt(f.a)
    f.inv = 1.0 / f.sqa
    f.ud = _map(lambda di: di * f.inv, d)
    lamb_dir = _map(lambda ni, si: ni + si, f.n, f.ss)
    tiny = (lamb_dir[0].abs() < NEAR_ZERO) & (lamb_dir[1].abs() < NEAR_ZERO) & (
        lamb_dir[2].abs() < NEAR_ZERO)
    lamb_dir = _sel(tiny, f.n, lamb_dir)
    f.ud_n = _dot(f.ud, f.n)
    f.k = 2.0 * f.ud_n
    refl = _map(lambda ui, ni: ui - f.k * ni, f.ud, f.n)
    metal_dir = _map(lambda ri, si: ri + f.prm * si, refl, f.ss)
    metal_ok = _dot(metal_dir, f.n) > 0.0
    # dielectric
    f.eta = torch.where(f.front, 1.0 / f.prm, f.prm)
    f.negudn = -f.ud_n
    f.cos_t = torch.clamp(f.negudn, max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - f.cos_t * f.cos_t, min=1e-12, max=1.0))
    f.cannot = sin_t * f.eta > 1.0
    f.d1 = 1.0 + f.eta
    f.q = (1.0 - f.eta) / f.d1
    f.r0 = f.q * f.q
    f.om = 1.0 - f.cos_t
    f.om2 = f.om * f.om
    f.A = 1.0 - f.r0
    f.P1 = f.A * f.om2
    f.P2 = f.P1 * f.om2
    f.rp = f.r0 + f.P2 * f.om
    f.use_reflect = f.cannot | (f.rp > u[:, 2])
    p_c = torch.clamp(f.rp, LR_P_LO, LR_P_HI)
    f.pb = torch.where(f.use_reflect, p_c, 1.0 - p_c)
    f.w = _map(lambda ui, ni: ui + f.cos_t * ni, f.ud, f.n)
    f.perp = _map(lambda wi: f.eta * wi, f.w)
    plen = _dot(f.perp, f.perp)
    f.one_m_plen = 1.0 - plen
    f.sqm = torch.sqrt(torch.clamp(f.one_m_plen.abs(), min=1e-12))
    f.par = -f.sqm
    refr = _map(lambda pi, ni: pi + f.par * ni, f.perp, f.n)
    diel_dir = _sel(f.use_reflect, refl, refr)
    f.dir = _sel(f.lamb, lamb_dir, _sel(f.metal, metal_dir, diel_dir))
    one = torch.ones_like(f.a)
    f.att = _sel(f.lamb | f.metal, f.tex, (one, one, one))
    f.scattered = f.lamb | (f.metal & metal_ok) | f.diel
    return f


def _sky(d):
    """sky_color(d)'s intermediates: (a, sqrt(a), 1 / sqrt(a), sa)."""
    a = _dot(d, d)
    sqa = torch.sqrt(a)
    inv = 1.0 / sqa
    return a, sqa, inv, 0.5 * (d[1] * inv + 1.0)


def _background(d, background, sky_gradient: bool):
    if sky_gradient:
        sa = _sky(d)[3]
        return (1.0 - sa) + sa * 0.5, (1.0 - sa) + sa * 0.7, torch.ones_like(sa)
    return tuple(background[i].expand_as(d[0]) for i in range(3))


class ReplayForward(NamedTuple):
    radiance: torch.Tensor  # (L, 3)
    state: torch.Tensor  # (rows, STATE_COLS): origin, direction, throughput a lane-bounce
    segments: torch.Tensor  # (L,) int32


class ReplayAdjoint(NamedTuple):
    rows: torch.Tensor  # (rows, ROW_COLS) cotangent rows, table layout
    index: torch.Tensor  # (rows,) int32 the rows' primitives (0: a zero row)
    lane: torch.Tensor  # (L, LANE_COLS): cotangents of o0, d0, the flat background


def replay_forward_plain(table, geom, ns: int, tape, lanes, offs, depth, rows: int, o0, d0,
                         background, seed: int, sky_gradient: bool) -> ReplayForward:
    """Plain twin of the forward kernel: lanes (sample ids) `lanes` from
    their first rays o0, d0 (L, 3), bounce b's winner tape[b, lane], at most
    depth[l] bounces, state row offs[l] + b."""
    dev = o0.device
    n_lanes = lanes.shape[0]
    rad = torch.zeros(n_lanes, 3, dtype=torch.float32, device=dev)
    segs = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    state = torch.zeros(rows, STATE_COLS, dtype=torch.float32, device=dev)
    act = torch.arange(n_lanes, device=dev)
    o, d = _vec(o0), _vec(d0)
    one = torch.ones(n_lanes, dtype=torch.float32, device=dev)
    tp = (one, one, one)
    for b in range(tape.shape[0]):
        keep = depth[act] > b
        act, o, d, tp = act[keep], *(_map(lambda x: x[keep], v) for v in (o, d, tp))
        if act.numel() == 0:
            break
        state[offs[act] + b] = torch.stack([*o, *d, *tp], 1)
        segs[act] = b + 1
        f = _forward_bounce(table, geom, ns, tape[b, lanes[act]], o, d,
                            ctr_rng.bounce_uniforms(seed, lanes[act], b))
        miss = ~f.hit
        light = f.hit & f.light
        bg = _background(d, background, sky_gradient)
        rad_a = _vec(rad[act])
        rad_a = _sel(miss, _map(lambda r, t, c: r + t * c, rad_a, tp, bg),
                     _sel(light, _map(lambda r, t, c: r + t * c, rad_a, tp, f.tex), rad_a))
        rad[act] = torch.stack(rad_a, 1)
        cont = f.hit & ~f.light & f.scattered
        tp = _map(lambda t, a: t * a, tp, f.att)
        act, o, d, tp = act[cont], *(_map(lambda x: x[cont], v) for v in (f.pt, f.dir, tp))
    return ReplayForward(rad, state, segs)


def replay_adjoint_plain(table, geom, ns: int, tape, lanes, offs, depth, fwd: ReplayForward,
                         grad, background, seed: int, sky_gradient: bool) -> ReplayAdjoint:
    """Plain twin of the adjoint kernel: the reverse sweep of the forward
    `fwd` under the radiance cotangent `grad` (L, 3), bounce by bounce from
    the deepest, each recomputed from its stored state. Every `if` of the
    kernel is a selection here, in the same place, so the rows equal the
    kernel's bit for bit on the card. `depth` sizes the layout only."""
    del depth  # slots past a lane's segments stay the zero rows of index 0
    dev = grad.device
    n_lanes = lanes.shape[0]
    n_rows = fwd.state.shape[0]
    rows = torch.zeros(n_rows, ROW_COLS, dtype=torch.float32, device=dev)
    index = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    zeros = torch.zeros(n_lanes, 3, dtype=torch.float32, device=dev)
    Gtp_all, Go_all, Gd_all, Gbg_all = (zeros.clone() for _ in range(4))
    segs = fwd.segments
    for b in reversed(range(tape.shape[0])):
        act = torch.nonzero(segs > b).flatten()
        if act.numel() == 0:
            continue
        cont = segs[act] > b + 1
        st = fwd.state[offs[act] + b]
        o, d, tp = _vec(st[:, 0:3]), _vec(st[:, 3:6]), _vec(st[:, 6:9])
        gc = _vec(grad[act])
        Gtp, Go, Gd = _vec(Gtp_all[act]), _vec(Go_all[act]), _vec(Gd_all[act])
        f = _forward_bounce(table, geom, ns, tape[b, lanes[act]], o, d,
                            ctr_rng.bounce_uniforms(seed, lanes[act], b))
        z = torch.zeros_like(o[0])
        z3 = (z, z, z)

        # ---- miss: the background ----
        Gbg = _vec(Gbg_all[act])
        if sky_gradient:
            _, sqa, inv, sa = _sky(d)
            c = ((1.0 - sa) + sa * 0.5, (1.0 - sa) + sa * 0.7, torch.ones_like(sa))
            cr, cg = gc[0] * tp[0], gc[1] * tp[1]
            Gsa = (cr * 0.5 - cr) + (cg * 0.7 - cg)
            Gy = 0.5 * Gsa
            mGd = (z, z + Gy * inv, z)
            Ginv = Gy * d[1]
            Gsqa = -(Ginv * (inv * inv))
            Ga = Gsqa / (2.0 * sqa)
            mGd = _map(lambda g, di: g + 2.0 * (Ga * di), mGd, d)
            mGtp = _map(lambda g, ci: g * ci, gc, c)
        else:
            bg = _background(d, background, False)
            Gbg = _sel(~f.hit, _map(lambda a, g, t: a + g * t, Gbg, gc, tp), Gbg)
            mGd = z3
            mGtp = _map(lambda g, ci: g * ci, gc, bg)

        # ---- hit ----
        light = f.light
        C = cont & ~light
        Gtex, Gn, Gpt, Gud, Grefl = z3, z3, z3, z3, z3
        Gprm = z
        refl_on = torch.zeros_like(C)
        nGtp = _sel(light, _map(lambda g, t: g * t, gc, f.tex),
                    _sel(C, _map(lambda g, a: g * a, Gtp, f.att), z3))
        Gtex = _sel(light, _map(lambda g, t: g * t, gc, tp), Gtex)
        Gatt = _map(lambda g, t: g * t, Gtp, tp)
        Gpt = _sel(C, Go, Gpt)
        Gdir = Gd
        m = C & f.lamb
        Gn = _sel(m, _map(lambda a, g: a + g, Gn, Gdir), Gn)
        Gtex = _sel(m, Gatt, Gtex)
        m = C & f.metal
        Grefl = _sel(m, Gdir, Grefl)
        refl_on = refl_on | m
        Gprm = torch.where(m, Gprm + _dot(Gdir, f.ss), Gprm)
        Gtex = _sel(m, Gatt, Gtex)
        # dielectric
        D = C & f.diel
        Geta, Gcos = z, z
        m = D & f.use_reflect
        Grefl = _sel(m, Gdir, Grefl)
        refl_on = refl_on | m
        m = D & ~f.use_reflect
        Gpar = _dot(Gdir, f.n)
        Gn = _sel(m, _map(lambda a, g: a + f.par * g, Gn, Gdir), Gn)
        Gm = (-Gpar) / (2.0 * f.sqm)
        Gabs = torch.where(f.one_m_plen.abs() >= 1e-12, Gm, 0.0)
        sgn = torch.where(f.one_m_plen > 0.0, 1.0, torch.where(f.one_m_plen < 0.0, -1.0, 0.0))
        Gplen = -(Gabs * sgn)
        Gperp = _map(lambda g, pi: g + 2.0 * (Gplen * pi), Gdir, f.perp)
        Geta = torch.where(m, Geta + _dot(Gperp, f.w), Geta)
        Gw = _map(lambda g: f.eta * g, Gperp)
        Gud = _sel(m, _map(lambda a, g: a + g, Gud, Gw), Gud)
        Gcos = torch.where(m, Gcos + _dot(Gw, f.n), Gcos)
        Gn = _sel(m, _map(lambda a, g: a + f.cos_t * g, Gn, Gw), Gn)
        m = D & ~f.cannot  # the likelihood ratio p / p.detach()
        Glr = Gatt[0] + Gatt[1] + Gatt[2]
        Gpb = Glr / f.pb
        Gp = torch.where(f.use_reflect, Gpb, -Gpb)
        Grp = torch.where((f.rp >= LR_P_LO) & (f.rp <= LR_P_HI), Gp, 0.0)
        Gr0 = Grp
        GP2 = Grp * f.om
        Gom = Grp * f.P2
        GP1 = GP2 * f.om2
        Gom2 = GP2 * f.P1
        GA = GP1 * f.om2
        Gom2 = Gom2 + GP1 * f.A
        Gr0 = Gr0 - GA
        Gom = Gom + 2.0 * (Gom2 * f.om)
        Gcos = torch.where(m, Gcos - Gom, Gcos)
        Gq = 2.0 * (Gr0 * f.q)
        Gn1 = Gq / f.d1
        Gd1 = -(Gq * (f.q / f.d1))
        Geta = torch.where(m, (Geta - Gn1) + Gd1, Geta)
        m = D & (f.negudn <= 1.0)  # cos_t = min(-(ud.n), 1)
        Gud = _sel(m, _map(lambda a, ni: a - Gcos * ni, Gud, f.n), Gud)
        Gn = _sel(m, _map(lambda a, ui: a - Gcos * ui, Gn, f.ud), Gn)
        Gprm = torch.where(D, Gprm + torch.where(f.front, -(Geta * (f.eta * f.eta)), Geta), Gprm)
        # refl = ud - (2 ud.n) n
        m = refl_on
        Gud = _sel(m, _map(lambda a, g: a + g, Gud, Grefl), Gud)
        Gk = -_dot(Grefl, f.n)
        Gn = _sel(m, _map(lambda a, g: a - g * f.k, Gn, Grefl), Gn)
        Gudn = 2.0 * Gk
        Gud = _sel(m, _map(lambda a, ni: a + Gudn * ni, Gud, f.n), Gud)
        Gn = _sel(m, _map(lambda a, ui: a + Gudn * ui, Gn, f.ud), Gn)
        # ud = d / sqrt(d.d), on every lane but a light's
        nGd = z3
        m = ~light
        nGd = _sel(m, _map(lambda a, g: a + g * f.inv, nGd, Gud), nGd)
        Ginv = _dot(Gud, d)
        Gsqa = -(Ginv * (f.inv * f.inv))
        Ga = Gsqa / (2.0 * f.sqa)
        nGd = _sel(m, _map(lambda a, di: a + 2.0 * (Ga * di), nGd, d), nGd)
        # normal = outward * sign
        Gout = _map(lambda g: g * f.sgn, Gn)
        rz = [z] * ROW_COLS
        q = f.quad
        Gs = _map(lambda g: g / f.s_len, Gout)
        Gslen = -(Gout[0] * (f.su[0] / f.s_len) + Gout[1] * (f.su[1] / f.s_len)
                  + Gout[2] * (f.su[2] / f.s_len))
        Gss = Gslen / (2.0 * f.s_len)
        Gs = _map(lambda g, si: g + 2.0 * (Gss * si), Gs, f.s)
        pmg = _map(lambda pi, gi: pi - gi, f.pt, f.g)
        Gpg = _map(lambda g: g * f.g3, Gs)
        rz[3] = torch.where(q, rz[3], rz[3] + _dot(Gs, pmg))
        Gpt = _sel(q, Gpt, _map(lambda a, g: a + g, Gpt, Gpg))
        for i in range(3):
            rz[i] = torch.where(q, rz[i] + Gout[i], rz[i] - Gpg[i])
        rz[5] = rz[5] + Gprm
        for i in range(3):
            rz[9 + i] = torch.where(f.use_c1, rz[9 + i] + Gtex[i], rz[9 + i])
            rz[6 + i] = torch.where(f.use_c1, rz[6 + i], rz[6 + i] + Gtex[i])
        # pt = o + t d
        nGo = _map(lambda a, g: a + g, z3, Gpt)
        Gt = _dot(Gpt, d)
        nGd = _map(lambda a, g: a + f.t * g, nGd, Gpt)
        # the sphere's t
        Gsq = torch.where(f.first, -(Gt * f.inv_a), Gt * f.inv_a)
        Ghb = -(Gt * f.inv_a)
        Ginva = Gt * f.num
        Ga2 = -(Ginva * (f.inv_a * f.inv_a))
        Gdisc = torch.where(f.disc_ok, Gsq / (2.0 * f.sq), 0.0)
        Ghb = Ghb + 2.0 * (Gdisc * f.hb)
        Ga2 = Ga2 - Gdisc * f.cq
        Gcq = -(Gdisc * f.a_t)
        Goc = _map(lambda oci: 2.0 * (Gcq * oci), f.oc)
        Gr = -(2.0 * (Gcq * f.r))
        sGd = _map(lambda a, oci: a + Ghb * oci, nGd, f.oc)
        Goc = _map(lambda a, di: a + Ghb * di, Goc, d)
        sGd = _map(lambda a, di: a + 2.0 * (Ga2 * di), sGd, d)
        sGo = _map(lambda a, g: a + g, nGo, Goc)
        # the quad's t
        Gnum = Gt / f.safe
        Gsafe = -(Gt * (f.tq / f.safe))
        Gnq = _sel(f.denom_ok, _map(lambda a, di: a + Gsafe * di, z3, d), z3)
        qGd = _sel(f.denom_ok, _map(lambda a, gi: a + Gsafe * gi, nGd, f.gq), nGd)
        qGo = _map(lambda a, gi: a - Gnum * gi, nGo, f.gq)
        Gnq = _map(lambda a, oi: a - Gnum * oi, Gnq, o)
        for i in range(3):
            rz[12 + i] = torch.where(q, rz[12 + i] + Gnq[i], rz[12 + i] - Goc[i])
        rz[15] = torch.where(q, rz[15] + Gnum, rz[15] + Gr)
        nGd = _sel(q, qGd, sGd)
        nGo = _sel(q, qGo, sGo)

        hit = f.hit
        row = torch.where(hit[:, None], torch.stack(rz, 1), 0.0)
        rows[offs[act] + b] = row
        index[offs[act] + b] = torch.where(hit, f.prim, 0).to(torch.int32)
        Gtp_all[act] = torch.stack(_sel(hit, nGtp, mGtp), 1)
        Go_all[act] = torch.stack(_sel(hit, nGo, z3), 1)
        Gd_all[act] = torch.stack(_sel(hit, nGd, mGd), 1)
        Gbg_all[act] = torch.stack(Gbg, 1)
    return ReplayAdjoint(rows, index, torch.cat([Go_all, Gd_all, Gbg_all], 1))


# ---- the kernels ----


def _check_inputs(table, geom, tape, lanes, offs, depth, dev):
    p = table.shape[0]
    check_tensor("table", table, torch.float32, (p, ROW_COLS), dev)
    check_tensor("geom", geom, torch.float32, (p, 4), dev)
    check_tensor("tape", tape, torch.int32, (None, None), dev)
    n = lanes.shape[0]
    check_tensor("lanes", lanes, torch.int64, (n,), dev)
    check_tensor("offs", offs, torch.int64, (n,), dev)
    check_tensor("depth", depth, torch.int32, (n,), dev)
    check_float4_rows(table=table, geom=geom)
    if tape.shape[1] >= 2**31:
        raise ValueError(f"tape: {tape.shape[1]} samples, the kernels take fewer than 2^31")


def replay_forward(table, geom, ns: int, tape, lanes, offs, depth, rows: int, o0, d0,
                   background, seed: int, sky_gradient: bool) -> ReplayForward:
    """The forward of lanes `lanes` (int64 sample ids) from their first
    rays o0, d0 (L, 3): one launch of the forward kernel on CUDA tensors,
    `replay_forward_plain` on CPU tensors. `tape` is the (max_depth, total)
    int32 tape, `offs` and `rows` the scratch layout (`scratch_layout` of
    the int32 depth bounds `depth`)."""
    global LAUNCHES
    dev = o0.device
    if dev.type == "cpu":
        return replay_forward_plain(table, geom, ns, tape, lanes, offs, depth, rows, o0, d0,
                                    background, seed, sky_gradient)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_inputs(table, geom, tape, lanes, offs, depth, dev)
    n = lanes.shape[0]
    check_tensor("o0", o0, torch.float32, (n, 3), dev)
    check_tensor("d0", d0, torch.float32, (n, 3), dev)
    check_tensor("background", background, torch.float32, (3,), dev)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    out = ReplayForward(torch.empty(n, 3, dtype=torch.float32, device=dev),
                        torch.empty(rows, STATE_COLS, dtype=torch.float32, device=dev),
                        torch.empty(n, dtype=torch.int32, device=dev))
    if n == 0:
        return out
    lib = load_kernels()
    err = lib.rt_replay_forward(
        table.data_ptr(), geom.data_ptr(), ns, tape.data_ptr(), tape.shape[1],
        lanes.data_ptr(), offs.data_ptr(), depth.data_ptr(), n, o0.data_ptr(), d0.data_ptr(),
        background.data_ptr(), ctypes.c_int(int(seed) & 0xFFFFFFFF).value, tape.shape[0],
        int(sky_gradient), out.radiance.data_ptr(), out.state.data_ptr(),
        out.segments.data_ptr(), THREADS, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("rt_replay_forward", err)
    LAUNCHES += 1
    return out


def replay_adjoint(table, geom, ns: int, tape, lanes, offs, depth, fwd: ReplayForward, grad,
                   background, seed: int, sky_gradient: bool) -> ReplayAdjoint:
    """The reverse sweep of `fwd` under the radiance cotangent `grad` (L, 3):
    one launch of the adjoint kernel on CUDA tensors,
    `replay_adjoint_plain` on CPU tensors."""
    global LAUNCHES_ADJOINT
    dev = grad.device
    if dev.type == "cpu":
        return replay_adjoint_plain(table, geom, ns, tape, lanes, offs, depth, fwd, grad,
                                    background, seed, sky_gradient)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_inputs(table, geom, tape, lanes, offs, depth, dev)
    n, rows = lanes.shape[0], fwd.state.shape[0]
    check_tensor("grad", grad, torch.float32, (n, 3), dev)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    out = ReplayAdjoint(torch.empty(rows, ROW_COLS, dtype=torch.float32, device=dev),
                        torch.empty(rows, dtype=torch.int32, device=dev),
                        torch.empty(n, LANE_COLS, dtype=torch.float32, device=dev))
    if n == 0:
        return out
    lib = load_kernels()
    err = lib.rt_replay_adjoint(
        table.data_ptr(), geom.data_ptr(), ns, tape.data_ptr(), tape.shape[1],
        lanes.data_ptr(), offs.data_ptr(), depth.data_ptr(), fwd.segments.data_ptr(), n,
        fwd.state.data_ptr(), grad.data_ptr(), background.data_ptr(),
        ctypes.c_int(int(seed) & 0xFFFFFFFF).value, int(sky_gradient), out.rows.data_ptr(),
        out.index.data_ptr(), out.lane.data_ptr(), THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("rt_replay_adjoint", err)
    LAUNCHES_ADJOINT += 1
    return out


def reduce_rows(adj: ReplayAdjoint, n_prims: int):
    """(table cotangent (P, 16), intersection-table cotangent (P, 4)): the
    adjoint's rows summed by primitive (ops/gather_kernel.py:
    gather_backward, fixed order), split into the two tables."""
    summed = gather_kernel.gather_backward(adj.rows, adj.index, n_prims)
    g_table = summed.clone()
    g_table[:, list(TABLE_NO_GRAD_COLS)] = 0.0
    return g_table, summed[:, GEOM_COLS].contiguous()


class ReplayPath(torch.autograd.Function):
    """(radiance (L, 3), segments (L,) int32) of the lanes `lanes` replayed
    from `tape`, with the hand-written adjoint as the radiance's backward.
    Differentiable inputs: the primitive table (P, 16), the intersection
    table (P, 4) (`geom_table`), the first rays o0, d0 (L, 3) and the flat
    background (3,)."""

    @staticmethod
    def forward(ctx, table, geom, o0, d0, background, tape, lanes, depth, seed, ns, sky_gradient):
        table, geom = table.detach().contiguous(), geom.detach().contiguous()
        background = background.detach().contiguous()
        offs, rows = scratch_layout(depth)
        fwd = replay_forward(table, geom, ns, tape, lanes, offs, depth, rows,
                             o0.detach().contiguous(), d0.detach().contiguous(), background,
                             seed, sky_gradient)
        ctx.args = (table, geom, ns, tape, lanes, offs, depth, fwd)
        ctx.bg = background
        ctx.cfg = (seed, sky_gradient)
        ctx.mark_non_differentiable(fwd.segments)
        return fwd.radiance, fwd.segments

    @staticmethod
    @once_differentiable
    def backward(ctx, grad, _segments):
        table, geom, ns, tape, lanes, offs, depth, fwd = ctx.args
        seed, sky_gradient = ctx.cfg
        adj = replay_adjoint(table, geom, ns, tape, lanes, offs, depth, fwd,
                             grad.contiguous(), ctx.bg, seed, sky_gradient)
        need = ctx.needs_input_grad
        g_table = g_geom = None
        if need[0] or need[1]:
            g_table, g_geom = reduce_rows(adj, table.shape[0])
        g_bg = adj.lane[:, 6:9].sum(0) if need[4] and not sky_gradient else None
        ctx.args = None
        return (g_table, g_geom, adj.lane[:, 0:3], adj.lane[:, 3:6], g_bg,
                None, None, None, None, None, None)


def replay_path(table, geom, o0, d0, background, tape, lanes, depth, *, seed: int, ns: int,
                sky_gradient: bool):
    """`ReplayPath.apply`: (radiance (L, 3), segments (L,) int32) of the
    lanes (int64 sample ids) `lanes`, each at most depth[l] (int32)
    bounces."""
    return ReplayPath.apply(table, geom, o0, d0, background, tape, lanes, depth, seed, ns,
                            sky_gradient)
