"""Table reads whose backward reduces hot rows without a sort.

`gather_rows(table, idx)` is `table[idx]` for a table of shape (R,) or
(R, C) and a 1-D index of rows in [0, R). Where autograd records it (grad
enabled and a table that requires grad) it goes through `TableGather`, an
autograd Function: the forward is `index_select`, and the backward is
`gather_backward`, which launches the hand-written CUDA kernel of
`csrc/gather_kernel.cu` on CUDA tensors and takes its plain twin,
`gather_backward_plain` (index_add_), on CPU tensors. Elsewhere it is
plain advanced indexing. The eager replay's reads of the primitive table,
the sphere centres and radii and the quad normals and offsets take it
(materials/materials.py:resolve_and_shade, geometry/intersect.py:
winner_t_diff), and the replay kernels sum their lane-bounce cotangent rows
with `gather_backward` (ops/replay_kernel.py:reduce_rows).

Why: PyTorch's backward of `table[idx]` on the card is index_put_ with
accumulate, which sorts the indices and walks each row's duplicates with
one warp; the replay's indices are skewed (miss lanes read row 0, the
ground sphere takes a large share of the hits), so that walk was most of a
train step. The kernel's design (the source note has it) does not depend
on the skew, and is deterministic. Every table size takes it: one that
does not fit the shared-memory budget is cut into row tiles
(`launch_plan`), so no size falls back to plain indexing.

Counters (utils/trace.py): each engaged read counts `table_gathers` and
`table_gather_rows` (its positions) on every open span.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from raytracer_tpu_torch.utils import trace as tr

# Shared memory a block of pass 1 may take: two blocks fit one SM's 228 KB.
SMEM_BUDGET = 112 * 1024
# Warps a block of pass 1, each with its own copy of the block's row tile.
MAX_WARPS = 8
# Pass 1 aims at this many blocks an SM, and gives a warp at least this
# many positions before it adds a block: a warp's walk is serial, and a
# block costs about as much as 64 positions to clear and write its copies.
BLOCKS_PER_SM = 2
MIN_POSITIONS_PER_WARP = 64
# The (blocks, R, C) partial is kept within this many bytes.
SCRATCH_BYTES = 64 << 20
# Threads per block of pass 2.
SUM_THREADS = 256

# CUDA launches of the backward kernel, one a backward whether it takes one
# pass or two (plain-twin calls do not count).
LAUNCHES = 0


class LaunchPlan(NamedTuple):
    """Pass 1's grid (blocks x tiles), its warps a block and its row tile;
    with one block, pass 1 writes the gradient and pass 2 does not run."""

    blocks: int
    tiles: int
    warps: int
    tile_rows: int


def launch_plan(rows: int, cols: int, n: int, sms: int) -> LaunchPlan:
    """The launch shape of the backward for `n` positions into a (rows,
    cols) float32 table on a card of `sms` SMs. It depends on these shapes
    alone, so a backward is bit-identical from run to run."""
    copy_bytes = rows * cols * 4
    if copy_bytes <= SMEM_BUDGET:
        warps = min(MAX_WARPS, SMEM_BUDGET // max(copy_bytes, 1))
        tile_rows = rows
    else:
        warps = 1
        tile_rows = SMEM_BUDGET // (cols * 4)
        if tile_rows < 1:
            raise ValueError(f"a row of {cols} floats exceeds the {SMEM_BUDGET}-byte tile")
    tiles = max(1, math.ceil(rows / tile_rows))
    blocks = min(math.ceil(n / (warps * MIN_POSITIONS_PER_WARP)),
                 max(1, BLOCKS_PER_SM * sms // tiles),
                 max(1, SCRATCH_BYTES // max(copy_bytes, 1)))
    return LaunchPlan(max(1, blocks), tiles, warps, tile_rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rounding_bound(grad, idx, rows: int, plan: LaunchPlan):
    """(rows, C) float64 bound of the kernel's float32 error against the
    exact sums, on the host: each element adds its terms in a chain of at
    most a warp's positions, then the plan's warps, then its blocks, so
    its error is at most that many times 2^-24 times the sum of its terms'
    magnitudes (first order)."""
    per_warp = math.ceil(math.ceil(idx.shape[0] / plan.blocks) / plan.warps)
    chain = per_warp + plan.warps + plan.blocks
    mags = gather_backward_plain(grad.detach().double().abs().cpu(), idx.cpu(), rows)
    return chain * 2.0**-24 * mags


def gather_backward_plain(grad, idx, rows: int):
    """Plain twin of the kernel, CPU tensors only: (rows, C) sums of the
    cotangent rows `grad` (N, C) at the rows `idx` (N,)."""
    out = torch.zeros(rows, grad.shape[1], dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, idx, grad)


def gather_backward(grad, idx, rows: int):
    """(rows, C) sums of the cotangent rows `grad` (N, C) at the rows `idx`
    (N,) int32 or int64, each in [0, rows). CPU tensors take
    `gather_backward_plain`; CUDA tensors launch the kernel (or raise)."""
    global LAUNCHES
    dev = grad.device
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx: expected int32 or int64, got {idx.dtype}")
    if idx.dim() != 1 or idx.device != dev:
        raise ValueError(f"idx: expected one dimension on {dev}, got shape "
                         f"{tuple(idx.shape)} on {idx.device}")
    if grad.dim() != 2 or grad.shape[0] != idx.shape[0]:
        raise ValueError(f"grad: expected ({idx.shape[0]}, C), got {tuple(grad.shape)}")
    if dev.type == "cpu":
        return gather_backward_plain(grad, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if grad.dtype != torch.float32:
        raise TypeError(f"grad: the kernel takes float32, got {grad.dtype}")
    grad, idx = grad.contiguous(), idx.contiguous()
    n, cols = grad.shape
    if n >= 2**31:
        raise ValueError(f"grad: {n} positions, the kernel takes fewer than 2^31")
    if n == 0 or rows == 0 or cols == 0:
        return torch.zeros(rows, cols, dtype=grad.dtype, device=dev)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    plan = launch_plan(rows, cols, n, _sm_count(dev.index))
    out = torch.empty(rows, cols, dtype=grad.dtype, device=dev)
    partial = out if plan.blocks == 1 else torch.empty(plan.blocks, rows, cols,
                                                       dtype=grad.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_gather_backward(
        grad.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), n, rows, cols,
        plan.tile_rows, plan.tiles, plan.blocks, plan.warps, partial.data_ptr(),
        out.data_ptr(), SUM_THREADS, stream,
    )
    check_launch("rt_gather_backward", err)
    LAUNCHES += 1
    return out


class TableGather(torch.autograd.Function):
    """table[idx] along dim 0 with `gather_backward` as its backward."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        g = gather_backward(grad.reshape(idx.shape[0], math.prod(shape[1:])), idx, shape[0])
        return g.reshape(shape), None


def gather_rows(table, idx):
    """table[idx] for a table (R,) or (R, C) and rows idx (N,) in [0, R):
    through TableGather where autograd records the read (counted as
    `table_gathers` and `table_gather_rows`), plain indexing elsewhere."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    tr.count("table_gathers")
    tr.count("table_gather_rows", idx.numel())
    return TableGather.apply(table, idx)
