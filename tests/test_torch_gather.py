"""The table gather of ops/gather_kernel.py: its plain twin against
autograd's own `table[idx]`, its launch plan, where the replay's reads take
it, and its counters; `cuda`-marked tests hold the CUDA backward against
the twin on the card. This file imports no jax, so on a machine with a card
it runs alone:

    python -m pytest --noconftest -o markers="cuda: needs a CUDA device" \\
        -m cuda tests/test_torch_gather.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.geometry.intersect import quad_derived, winner_t_diff
from raytracer_tpu_torch.materials.materials import resolve_and_shade
from raytracer_tpu_torch.materials.packed import primitive_table
from raytracer_tpu_torch.ops import gather_kernel as gk
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils import trace

torch.set_num_threads(1)

# The shapes of the rand_spheres train cell's reads: 489 rows (488 spheres
# and one quad) of the primitive table's 16 columns, the centres' 3 and
# the radii's 1; 720,000 positions at the first bounce.
CELL_ROWS = 489
CELL_POSITIONS = 720_000
H100_SMS = 132


@pytest.fixture
def recorder():
    """The recorder on for the test, off and emptied after it."""
    trace.collect()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.collect()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def skewed_index(n, rows, hot_share, seed, dtype=torch.int64, device="cpu"):
    """n row indices, `hot_share` of them row 0 and the rest uniform."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, rows, n)
    idx[rng.uniform(size=n) < hot_share] = 0
    return torch.from_numpy(idx).to(dtype=dtype, device=device)


def autograd_pair(table, idx, grad):
    """(forward, gradient) of gather_rows and of plain advanced indexing
    under the same cotangent."""
    out = []
    for fn in (gk.gather_rows, lambda t, i: t[i]):
        t = table.detach().clone().requires_grad_(True)
        y = fn(t, idx)
        (g,) = torch.autograd.grad(y, t, grad)
        out.append((y.detach(), g))
    return out


INDEX_CASES = {
    "uniform": lambda n, r: skewed_index(n, r, 0.0, 1),
    "all_on_one_row": lambda n, r: torch.full((n,), r // 2, dtype=torch.int64),
    "ninety_percent_row_0": lambda n, r: skewed_index(n, r, 0.9, 2),
    "empty": lambda n, r: torch.zeros(0, dtype=torch.int64),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("cols", [None, 1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_equals_advanced_indexing(case, index_dtype, cols, dtype):
    rows, n = 37, 500
    g = torch.Generator().manual_seed(5)
    shape = (rows,) if cols is None else (rows, cols)
    table = torch.randn(shape, generator=g, dtype=dtype)
    idx = INDEX_CASES[case](n, rows).to(index_dtype)
    grad = torch.randn((idx.shape[0], *shape[1:]), generator=g, dtype=dtype)
    (y, gy), (y_ref, g_ref) = autograd_pair(table, idx, grad)
    assert y.shape == y_ref.shape and torch.equal(y, y_ref)
    assert gy.shape == table.shape
    # The same sums in another order at most: float64 is exact here to
    # rounding, float32 within its rounding of up to n terms.
    tol = n * torch.finfo(dtype).eps * float(grad.abs().sum())
    assert float((gy - g_ref).abs().max()) <= tol


@pytest.mark.parametrize("cols", [None, 3])
def test_gradcheck_float64(cols):
    rows = 9
    shape = (rows,) if cols is None else (rows, cols)
    table = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([0, 0, 0, 4, 8, 0, 2, 2], dtype=torch.int64)
    assert torch.autograd.gradcheck(lambda t: gk.gather_rows(t, idx), (table,))


def test_twin_is_index_add():
    grad = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([2, 0, 2, 2])
    got = gk.gather_backward(grad, idx, 3)
    want = torch.tensor([[3.0, 4, 5], [0, 0, 0], [0 + 6 + 9, 1 + 7 + 10, 2 + 8 + 11]])
    assert torch.equal(got, want)


def test_backward_refuses_what_it_does_not_take():
    grad = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        gk.gather_backward(grad, torch.zeros(4, dtype=torch.int16), 3)
    with pytest.raises(ValueError):
        gk.gather_backward(grad, torch.zeros(4, 1, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        gk.gather_backward(grad, torch.zeros(5, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        gk.gather_backward(torch.zeros(4, 3, device="meta"),
                           torch.zeros(4, dtype=torch.int64, device="meta"), 3)


@pytest.mark.parametrize("rows,cols", [(CELL_ROWS, 16), (CELL_ROWS, 3), (CELL_ROWS, 1),
                                       (50_000, 3), (50_000, 16), (7, 2000)])
@pytest.mark.parametrize("n", [0, 1, 1000, CELL_POSITIONS])
def test_launch_plan_fits_the_card(rows, cols, n):
    plan = gk.launch_plan(rows, cols, n, H100_SMS)
    assert plan.warps * plan.tile_rows * cols * 4 <= gk.SMEM_BUDGET
    assert 1 <= plan.warps <= gk.MAX_WARPS
    assert plan.tiles * plan.tile_rows >= rows > (plan.tiles - 1) * plan.tile_rows
    assert plan.blocks >= 1
    assert plan.blocks == 1 or plan.blocks * rows * cols * 4 <= gk.SCRATCH_BYTES
    assert plan.blocks * plan.tiles <= max(gk.BLOCKS_PER_SM * H100_SMS, plan.tiles)
    assert plan == gk.launch_plan(rows, cols, n, H100_SMS)


def test_launch_plan_tiles_only_large_tables():
    assert gk.launch_plan(CELL_ROWS, 16, CELL_POSITIONS, H100_SMS).tiles == 1
    assert gk.launch_plan(50_000, 3, CELL_POSITIONS, H100_SMS).tiles > 1
    # Few positions take one block, which writes the gradient itself.
    assert gk.launch_plan(CELL_ROWS, 16, 100, H100_SMS).blocks == 1


def test_counters_fire_once_a_read(recorder):
    table = torch.randn(10, 3, requires_grad=True)
    idx = torch.tensor([0, 0, 5, 9, 0, 1, 0])
    with trace.span("outer"):
        gk.gather_rows(table, idx)
        gk.gather_rows(table.detach(), idx)  # no grad: plain, not counted
        with torch.no_grad():
            gk.gather_rows(table, idx)  # not recorded: plain, not counted
    (outer,) = trace.collect()
    assert outer["counts"] == {"table_gathers": 1, "table_gather_rows": 7}


def shading_inputs(n=64, seed=3):
    """rand_spheres' scene, a (t, prim, origin, direction, uniforms) of n
    lanes, a tenth of them misses."""
    scene, _, _ = get_scene("rand_spheres", width=16, spp=1, max_depth=4)
    rng = np.random.default_rng(seed)
    prim = torch.from_numpy(rng.integers(0, scene.num_prims, n)).to(torch.int32)
    t = torch.from_numpy(rng.uniform(0.5, 5.0, n).astype(np.float32))
    t[torch.from_numpy(rng.uniform(size=n) < 0.1)] = float("inf")
    o = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    return scene, t, prim, o, d, u


def counted_reads(fn):
    trace.collect()
    with trace.span("reads"):
        fn()
    (s,) = trace.collect()
    return s["counts"]


def test_resolve_and_shade_routes_by_grad(recorder):
    scene, t, prim, o, d, u = shading_inputs()
    table = primitive_table(scene, quad_derived(scene))

    def shade(tab):
        return resolve_and_shade(tab, scene.num_spheres, t, prim, o, d, u)

    with torch.no_grad():
        assert counted_reads(lambda: shade(table.requires_grad_(True))) == {}
    assert counted_reads(lambda: shade(table.detach())) == {}
    ref = shade(table.detach())
    live = table.detach().clone().requires_grad_(True)
    counts = counted_reads(lambda: shade(live))
    assert counts == {"table_gathers": 1, "table_gather_rows": t.shape[0]}
    got = shade(live)
    for a, b in zip(got, ref):
        assert torch.equal(a.detach(), b)


def test_winner_t_diff_routes_by_grad(recorder):
    scene, t, prim, o, d, _ = shading_inputs()
    qd = quad_derived(scene)

    def winners(sc, q):
        return winner_t_diff(sc, q, o, d, prim, t)

    with torch.no_grad():
        assert counted_reads(lambda: winners(dataclasses.replace(
            scene, sph_center=scene.sph_center.clone().requires_grad_(True)), qd)) == {}
    # Origins that need grad with tables that do not: plain reads.
    o.requires_grad_(True)
    assert counted_reads(lambda: winners(scene, qd)) == {}
    live = dataclasses.replace(scene,
                               sph_center=scene.sph_center.clone().requires_grad_(True),
                               sph_radius=scene.sph_radius.clone().requires_grad_(True))
    assert counted_reads(lambda: winners(live, qd)) == {
        "table_gathers": 2, "table_gather_rows": 2 * t.shape[0]}
    live_quads = qd._replace(normal=qd.normal.clone().requires_grad_(True),
                             d=qd.d.clone().requires_grad_(True))
    assert counted_reads(lambda: winners(live, live_quads)) == {
        "table_gathers": 4, "table_gather_rows": 4 * t.shape[0]}
    assert torch.equal(winners(live, live_quads).detach(), winners(scene, qd).detach())


def test_replay_gradient_equals_plain_indexing(monkeypatch):
    """A bucketed step's gradients through the gather equal those of the
    same step with every read plain, to float32 rounding of the sums'
    order."""
    from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
    from raytracer_tpu_torch.diff.grad import split_scene

    scene, cam, st = get_scene("rand_spheres", width=16, spp=2, max_depth=4)
    target = torch.full((st.height, st.width, 3), 0.5)
    kw = dict(width=st.width, height=st.height, samples_per_pass=2, max_depth=4)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(gk.TableGather, "apply", lambda t, i: t[i])
        params, rebuild = split_scene(scene)
        loss, g = make_bucketed_grad_fn(rebuild, cam, target, **kw)(params, 7)
        grads.append((float(loss), g))
    (loss_a, ga), (loss_b, gb) = grads
    assert loss_a == loss_b
    for k in ga:
        scale = float(gb[k].abs().max()) + 1e-30
        assert float((ga[k] - gb[k]).abs().max()) <= 1e-5 * scale, k


# ---- on the card ----


def kernel_against_twin(cuda, rows, cols, n, hot, seed, index_dtype=torch.int64):
    g = torch.Generator().manual_seed(seed)
    grad = torch.randn(n, cols, generator=g)
    idx = skewed_index(n, rows, hot, seed, index_dtype)
    got = gk.gather_backward(grad.to(cuda), idx.to(cuda), rows)
    again = gk.gather_backward(grad.to(cuda), idx.to(cuda), rows)
    torch.cuda.synchronize()
    want = gk.gather_backward_plain(grad.double(), idx, rows)
    plan = gk.launch_plan(rows, cols, n, torch.cuda.get_device_properties(cuda)
                          .multi_processor_count)
    tol = gk.rounding_bound(grad, idx, rows, plan)
    err = (got.cpu().double() - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    return got, again, plan


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [16, 3, 1])
def test_kernel_matches_twin_at_the_cells_shapes(cuda, cols):
    """rand_spheres' reads: 489 rows, 720,000 positions, 60% on row 0, held
    against the twin's float64 sums within the float32 rounding of the
    kernel's own summation order (`gather_kernel.rounding_bound`); two
    runs bit-identical."""
    got, again, plan = kernel_against_twin(cuda, CELL_ROWS, cols, CELL_POSITIONS, 0.6, cols)
    assert plan.tiles == 1 and plan.blocks > 1
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 5, 4099])
def test_kernel_small_launches(cuda, index_dtype, n):
    got, again, _ = kernel_against_twin(cuda, CELL_ROWS, 16, n, 0.6, n, index_dtype)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [3, 16])
def test_kernel_row_tiles(cuda, cols):
    """A table past the shared-memory budget, cut into row tiles."""
    got, again, plan = kernel_against_twin(cuda, 50_000, cols, 300_000, 0.6, 11)
    assert plan.tiles > 1
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_deterministic_through_autograd(cuda):
    """gather_rows' gradient on the card, bit-identical over two runs, and
    its launches counted."""
    table = torch.randn(CELL_ROWS, 16, device=cuda)
    idx = skewed_index(CELL_POSITIONS, CELL_ROWS, 0.6, 4, device=cuda)
    ct = torch.randn(CELL_POSITIONS, 16, device=cuda)
    grads = []
    gk.LAUNCHES = 0
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(gk.gather_rows(t, idx), t, ct)
        grads.append(g)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == 2
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(gk.gather_rows(table, idx), table[idx])


@pytest.mark.cuda
def test_kernel_refuses_float64(cuda):
    with pytest.raises(TypeError):
        gk.gather_backward(torch.zeros(4, 3, dtype=torch.float64, device=cuda),
                           torch.zeros(4, dtype=torch.int64, device=cuda), 3)
