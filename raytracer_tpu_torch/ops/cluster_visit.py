"""The twin of the two-level cluster walk (csrc/cluster_walk.cuh): the
dense search over a cluster-ordered scene's rows in the order the walk
visits them, and the per-lane and warp-union work the walk does.

Kernel 2's culled instantiations (integrator/wavefront.py:regen_plain),
kernel 1's clustered entry (ops/intersect_kernel.py:intersect_clustered)
and kernel 4 (ops/culled_kernel.py:intersect_culled) all take
`ClusterVisit.hit` as their closest hit's twin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.ops.intersect_kernel import (
    INF,
    QUAD_DENOM_EPS,
    T_MIN,
    candidates_scaled,
    check_float4_rows,
    check_tensor,
    intersect_plain,
    slab_inv,
)
from raytracer_tpu_torch.ops.persistent_kernel import CLUSTER_SLAB_PAD, check_cluster_table

# Candidate cells (rays x primitives) per block of ClusterVisit.hit_work.
WORK_CELLS = 1 << 24


class _KindVisit(NamedTuple):
    """One kind's clusters in the walk's visit order (ClusterVisit)."""

    dense: bool  # no clusters: the dense loop over all `size` rows
    size: int
    col0: int  # first column of the kind in the visit-ordered candidates
    fine_box: torch.Tensor  # (F, 6) visited fine rows' [min, max]
    fine_count: torch.Tensor  # (F,) int64 primitives per fine row
    fine_col: torch.Tensor  # (F,) first column of each fine row, within the kind
    super_box: torch.Tensor | None  # (S, 6), None without a super level
    super_col: torch.Tensor | None  # (S,) first column of each super
    fine_super: torch.Tensor | None  # (F,) position of each fine row's super
    super_fine: torch.Tensor | None  # (S,) fine rows per super


class ClusterVisit(NamedTuple):
    """The culled closest hit of csrc/cluster_walk.cuh (kernel 2's kCull
    instantiations, kernel 1's clustered entry, kernel 4), without
    culling: the sphere and quad table rows in the order the kernel visits
    them (supers in row order,
    their fine rows, each fine row's primitive range; a kind without rows
    in table order), built once per call from a ClusterTable. `hit` runs
    the dense search over the rows gathered in that order and maps the
    winner back to its table row: culling only skips clusters that cannot
    hold a strictly closer hit, and the first minimal candidate wins, so
    this is the kernel's result bit for bit, ties included. `hit_work`
    also counts per ray the slab tests, sphere tests and quad tests that
    the kernel's per-lane culling makes and, given each ray's warp, what
    the warps pay: a warp runs a loop while any of its lanes is in it, so
    it pays every super test, the fine tests of each super any of its
    lanes enters, and the primitive tests of each fine row any of its
    lanes enters."""

    prim_of: torch.Tensor  # (Ps + Pq,) int64 prim id of each visited row
    sph_rows: torch.Tensor  # (Ps, 4) sphere table rows in visit order
    quad_rows: torch.Tensor  # (Pq, 12) quad table rows in visit order
    kinds: tuple  # (_KindVisit spheres, _KindVisit quads)

    @staticmethod
    def build(clusters, sph_table, quad_table) -> "ClusterVisit":
        dev = sph_table.device
        rows = clusters.rows.cpu().numpy()
        s_super, s_fine, q_super, q_fine = clusters.counts
        ns, nq = sph_table.shape[0], quad_table.shape[0]
        kinds, idx = [], []
        col0 = 0
        for base, n_super, n_fine, size in ((0, s_super, s_fine, ns),
                                            (s_super + s_fine, q_super, q_fine, nq)):
            kind, order = _kind_visit(rows, base, n_super, n_fine, size, col0, dev)
            kinds.append(kind)
            idx.append(torch.from_numpy(order).to(dev))
            col0 += len(order)
        return ClusterVisit(torch.cat([idx[0], ns + idx[1]]), sph_table[idx[0]],
                            quad_table[idx[1]], tuple(kinds))

    def _to_table_rows(self, p):
        """Visit-ordered winner index (-1 on a miss) -> prim id."""
        return torch.where(p >= 0, self.prim_of[p.clamp(min=0).long()], -1).to(torch.int32)

    def hit(self, o, d):
        t, p = intersect_plain(self.sph_rows, self.quad_rows, o, d)
        return t, self._to_table_rows(p)

    def hit_work(self, o, d, warp=None):
        """(t, prim, work (WORK_ROWS, L) int64 per ray) and, given `warp`
        (L,) int64, each ray's warp in ascending order, also warp_work
        (WORK_ROWS + 1,) int64: each count of the rows of `work` that the
        warps pay (counted once per warp: one issue of a warp's instruction
        stands for its 32 lanes), then the number of warps.

        The rows of `work` (WORK_ROWS): slab tests, sphere tests, quad
        tests, and the data-dependent parts of csrc/closest_hit.cuh's loops
        among those tests: spheres whose discriminant is >= 0 (a root),
        quads whose plane faces the ray (a division), and quads whose t can
        still win there (the in-quad test)."""
        n = o.shape[0]
        dev = o.device
        t = torch.empty(n, dtype=torch.float32, device=dev)
        prim = torch.empty(n, dtype=torch.int32, device=dev)
        work = torch.zeros(WORK_ROWS, n, dtype=torch.int64, device=dev)
        warp_work = torch.zeros(WORK_ROWS + 1, dtype=torch.int64, device=dev)
        cols = max(1, self.sph_rows.shape[0] + self.quad_rows.shape[0])
        step = max(1, WORK_CELLS // cols)
        s = 0
        while s < n:
            e = min(n, s + step)
            if warp is not None:  # a block ends at a warp's end
                e = int(torch.searchsorted(warp, warp[e - 1], right=True))
            ob, db = o[s:e], d[s:e]
            wid = None
            if warp is not None:
                wid = torch.unique_consecutive(warp[s:e], return_inverse=True)[1]
                warp_work[WORK_ROWS] += int(wid[-1]) + 1

            def count(row, mask, weight=None):
                """Add a (rays, K) bool mask's entries (times `weight` (K,))
                to work row `row`, and its union over each warp's rays to
                warp_work."""
                work[row, s:e] += mask.sum(1) if weight is None else (mask * weight).sum(1)
                if wid is not None:
                    acc = torch.zeros(int(wid[-1]) + 1, mask.shape[1], dtype=torch.int32,
                                      device=dev)
                    any_lane = acc.index_add_(0, wid, mask.to(torch.int32)) > 0
                    warp_work[row] += (any_lane.sum() if weight is None
                                       else (any_lane * weight).sum())

            cands, a, (disc, d_n, num, t_q) = candidates_scaled(
                self.sph_rows, self.quad_rows, ob, db, terms=True)
            t_best, i = cands.min(dim=1)
            t[s:e] = t_best * (1.0 / a)
            prim[s:e] = self._to_table_rows(torch.where(t_best < INF, i, -1))
            # Each cluster's slab test sees the best hit of every earlier
            # visited row (a skipped cluster could not have lowered it).
            before = torch.cat([torch.full_like(cands[:, :1], INF),
                                torch.cummin(cands, dim=1).values[:, :-1]], dim=1)
            inv = slab_inv(db)
            ones = lambda k: torch.ones(e - s, k, dtype=torch.bool, device=dev)  # noqa: E731
            for k, kind in enumerate(self.kinds):
                if kind.dense:
                    tested = ones(kind.size)
                else:
                    enter = _slab_enters(kind.fine_box, ob, inv, a,
                                         before[:, kind.col0 + kind.fine_col])
                    if kind.super_box is None:
                        count(0, ones(kind.fine_box.shape[0]))
                    else:
                        sup = _slab_enters(kind.super_box, ob, inv, a,
                                           before[:, kind.col0 + kind.super_col])
                        count(0, ones(kind.super_box.shape[0]))
                        count(0, sup, kind.super_fine)
                        enter = enter & sup[:, kind.fine_super]
                    tested = torch.repeat_interleave(enter, kind.fine_count, dim=1)
                count(1 + k, tested)
                if kind.size == 0:
                    continue
                if k == 0:
                    count(3, tested & (disc >= 0.0))
                else:
                    # The early-out form of the quad test (its plane faces
                    # the ray; then its t can still win), the work the
                    # culled bounds count as needed.
                    faces = tested & (d_n.abs() >= QUAD_DENOM_EPS) & (
                        ((num > 0) & (d_n > 0)) | ((num < 0) & (d_n < 0)))
                    count(4, faces)
                    wins = faces & (t_q > T_MIN) & (
                        t_q * a[:, None] < before[:, kind.col0 : kind.col0 + kind.size])
                    count(5, wins)
            s = e
        if warp is not None:
            return t, prim, work, warp_work
        return t, prim, work


# Rows of ClusterVisit.hit_work's per-ray counts: slab, sphere and quad
# tests, sphere roots, quad divisions and quad in-quad tests.
WORK_ROWS = 6


def _kind_visit(rows, base: int, n_super: int, n_fine: int, size: int, col0: int, dev):
    """(_KindVisit, table rows in visit order) of one kind's table section."""
    empty = torch.zeros(0, device=dev)
    if n_fine == 0:
        return _KindVisit(True, size, col0, empty, empty, empty, None, None, None,
                          None), np.arange(size, dtype=np.int64)
    fine = rows[base + n_super : base + n_super + n_fine]
    if n_super:
        sup = rows[base : base + n_super]
        ranges = [np.arange(int(r[6]), int(r[6]) + int(r[7])) for r in sup]
        visit = np.concatenate(ranges)
        fine_super = np.repeat(np.arange(n_super), [len(r) for r in ranges])
    else:
        visit = np.arange(n_fine)
    f = fine[visit]
    count = f[:, 7].astype(np.int64)
    order = np.concatenate([np.arange(int(r[6]), int(r[6]) + int(r[7])) for r in f])
    fine_col = np.concatenate([[0], np.cumsum(count)[:-1]])
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    super_box = super_col = fs = super_fine = None
    if n_super:
        first = np.concatenate([[0], np.cumsum([len(r) for r in ranges])[:-1]])
        super_box, super_col = as_t(sup[:, :6]), as_t(fine_col[first])
        fs, super_fine = as_t(fine_super), as_t(np.array([len(r) for r in ranges]))
    return _KindVisit(False, size, col0, as_t(f[:, :6]), as_t(count), as_t(fine_col),
                      super_box, super_col, fs, super_fine), order.astype(np.int64)


def _slab_enters(box, origin, inv, a, t_best, pad=CLUSTER_SLAB_PAD):
    """(rays, boxes) bool: the cluster slab test (csrc/
    cluster_walk.cuh:cluster_enters) of each ray against each [min, max]
    box (K, 6), against the ray's best scaled t before that box (rays, K),
    on the interval padded by `pad` (the kernel's: CLUSTER_SLAB_PAD) each
    side."""
    lo = hi = None
    for k in range(3):
        o_k, i_k = origin[:, k : k + 1], inv[:, k : k + 1]
        t0 = (box[None, :, k] - o_k) * i_k
        t1 = (box[None, :, 3 + k] - o_k) * i_k
        tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
        lo = tn if lo is None else torch.maximum(lo, tn)
        hi = tf if hi is None else torch.minimum(hi, tf)
    lo = torch.clamp(lo - pad, min=T_MIN)
    a = a[:, None]
    return lo * a < torch.minimum((hi + pad) * a, t_best)


def check_clustered_inputs(clusters, sph_table, quad_table, origin, direction) -> None:
    """Raise unless a clustered closest hit (kernel 1's clustered entry,
    kernel 4) can take these inputs: a ClusterTable whose sections fit its
    rows, float32 sphere (S, 4) and quad (Q, 12) tables and (N, 3) rays, all
    contiguous on one CPU or CUDA device, the tables 16-byte aligned."""
    dev = origin.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    check_cluster_table(clusters, dev)
    check_tensor("sph_table", sph_table, torch.float32, (None, 4), dev)
    check_tensor("quad_table", quad_table, torch.float32, (None, 12), dev)
    check_tensor("origin", origin, torch.float32, (None, 3), dev)
    check_tensor("direction", direction, torch.float32, (origin.shape[0], 3), dev)
    check_float4_rows(clusters=clusters.rows, sph_table=sph_table, quad_table=quad_table)
