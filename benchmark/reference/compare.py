"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference works out, where 0 is agreement."""

from __future__ import annotations

import statistics

import torch

from benchmark.reference.train import BETA1, adam


def to_u8(linear):
    """8-bit image of linear radiance: gamma 2, clamp to [0, 1], times
    255.999, truncated; in the input's precision."""
    return (torch.clamp(torch.sqrt(torch.clamp(linear, min=0.0)), 0.0, 1.0) * 255.999).to(
        torch.uint8)


def pixel_gap(program, reference) -> float:
    """Sum of |program - reference| over the checked pixels and channels,
    over the sum of |reference|: the share of the image's radiance the two
    disagree on."""
    return float((program.double() - reference.double()).abs().sum()
                 / reference.double().abs().sum().clamp(min=1e-30))


def u8_off(program_u8, program_linear) -> int:
    """Pixels whose 8-bit value the program reported is more than one level
    off the tonemap of the program's own linear image, worked out in
    float64: a float32 tonemap rounds to the level beside the exact one
    where a value lies within rounding of a level's edge."""
    exact = to_u8(program_linear.double().cpu()).int()
    return int(((program_u8.cpu().int() - exact).abs() > 1).any(-1).sum())


def worst(values) -> float:
    """The largest of `values`, NaN where any is NaN."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gap(program: dict, reference: dict, leaves) -> float:
    """The worst of `leaves` by |norm(program) -
    norm(reference)|, over the larger of that leaf's reference norm and the
    median leaf's (over every leaf)."""
    ref = {k: norm(v) for k, v in reference.items()}
    median = statistics.median(ref.values())
    return worst(abs(norm(program[k]) - ref[k]) / max(ref[k], median, 1e-30) for k in leaves)


def moving_leaves(first_grad: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: norm(g) for k, g in first_grad.items()}
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * median]


def row_gap(program: dict, reference: dict, leaves) -> float:
    """The worst of `leaves` by the median, over the leaf's rows (a sphere's
    centre, a material's fuzz) whose reference norm is above 0, of
    |norm(program row) - norm(reference row)| / norm(reference row): a
    fault that moves a leaf's derivative moves most of its rows, where a
    few rows carried by a near-tangent hit swing with rounding."""
    gaps = [0.0]
    for k in leaves:
        if not (torch.isfinite(program[k]).all() and torch.isfinite(reference[k]).all()):
            return float("nan")
        p = program[k].double().cpu().reshape(program[k].shape[0], -1).norm(dim=1)
        r = reference[k].double().cpu().reshape(reference[k].shape[0], -1).norm(dim=1)
        live = r > 0
        if live.any():
            gaps.append(float(((p[live] - r[live]).abs() / r[live]).median()))
    return worst(gaps)


def loss_gaps(program: list, reference: list) -> list:
    """Each step's |program loss - reference loss| / reference loss."""
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference)]


def run_grads(run: dict) -> list:
    """Each step's gradient as the optimizer got it, from Adam's first
    moments: g_k = (m_k - 0.9 m_(k-1)) / 0.1, m_0 = 0."""
    out, prev = [], None
    for st in run["states"]:
        m = st["exp_avg"]
        out.append({k: (v - (0.0 if prev is None else BETA1 * prev[k])) / (1.0 - BETA1)
                    for k, v in m.items()})
        prev = m
    return out


def run_changes(run: dict) -> list:
    """Each step's change of the leaves from the state it started from."""
    before, out = run["start"], []
    for st in run["states"]:
        out.append({k: st["params"][k] - before[k] for k in before})
        before = st["params"]
    return out


def update_gap(run: dict, lr: float, leaves) -> float:
    """How far each step's update departs from Adam's, worked out from the
    state the run started the step from and the gradient its first moment
    took: the worst of `leaves` and steps by norm(change - Adam's change)
    over norm(Adam's change), and the same of the second moment. A
    reversed or rescaled step, or wrong betas, read about 1 or more."""
    gaps, before = [0.0], {"params": run["start"], "exp_avg": None, "exp_avg_sq": None}
    for i, (st, g) in enumerate(zip(run["states"], run_grads(run))):
        for k in leaves:
            p0 = before["params"][k].double()
            zero = torch.zeros_like(p0)
            m0 = zero if before["exp_avg"] is None else before["exp_avg"][k].double()
            v0 = zero if before["exp_avg_sq"] is None else before["exp_avg_sq"][k].double()
            p1, _, v1 = adam(p0, g[k].double(), m0, v0, i + 1, lr)
            stored = p1.to(st["params"][k].dtype).double()  # rounded as the run stores it
            gaps += [norm(st["params"][k].double() - stored) / max(norm(p1 - p0), 1e-30),
                     norm(st["exp_avg_sq"][k].double() - v1) / max(norm(v1), 1e-30)]
        before = st
    return worst(gaps)


def train_numbers(program: dict, reference: dict, check: dict, lr: float) -> dict:
    """The numbers a train cell compares. `program` holds each step's loss,
    the leaves it started from and the state after each step (leaves,
    "exp_avg", "exp_avg_sq"); `reference` is `train.follow`'s, its later
    steps started from the program's state. The worst step's loss gap; its
    gradient (from Adam's moments) by the gap of norms over
    `check["leaves"]` and by the median row over every leaf; its change by
    the gap of norms over the leaves the reference's first gradient moves;
    and its update against Adam's from the program's own state."""
    moving = moving_leaves(reference["grads"][0])
    grads = list(zip(run_grads(program), reference["grads"]))
    changes = list(zip(run_changes(program), reference["changes"]))
    return {"loss_gap": worst(loss_gaps(program["losses"], reference["losses"])),
            "grad_gap": worst(leaf_gap(p, r, check["leaves"]) for p, r in grads),
            "grad_row_gap": worst(row_gap(p, r, list(r)) for p, r in grads),
            "change_gap": worst(leaf_gap(p, r, moving) for p, r in changes),
            "update_gap": update_gap(program, lr, list(reference["grads"][0]))}


def train_look(program: dict, reference: dict) -> dict:
    """Every step's loss gap, and each step's gaps of every leaf's gradient
    and change, printed beside the numbers compared."""
    leaves = list(reference["grads"][0])
    grads = list(zip(run_grads(program), reference["grads"]))
    changes = list(zip(run_changes(program), reference["changes"]))
    return {"loss_gaps": loss_gaps(program["losses"], reference["losses"]),
            "grad_gaps": [{k: leaf_gap(p, r, [k]) for k in leaves} for p, r in grads],
            "grad_row_gaps": [{k: row_gap(p, r, [k]) for k in leaves} for p, r in grads],
            "change_gaps": [{k: leaf_gap(p, r, [k]) for k in leaves} for p, r in changes]}
