"""The comparison that decides ``correct``: a trajectory against the
reference's, number by number, each against its limit.

The numbers (PERF.md, "How correct is decided", gives the readings each
limit was set from):

* ``decisions``: mega-batches whose host decisions (u, number of rounds, b
  and lr after Algorithm 1, and for the first mega-batches Algorithm 2's
  weights) differ from the reference's replay; limit 0.
* ``loss``: the largest relative gap of a mega-batch's train loss.
* ``update1``: the first gradient as the optimizer gets it:
  ||global_1 - (sum_i alpha_i) w0|| by leaf, the first merge's weighted sum
  of the replicas' SGD updates (Algorithm 2's weights need not sum to 1,
  and the w0 they then scale would hide the update). The gap between the
  program's norm and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger; the worst leaf.
* ``change``: ||global_n - w0|| after the last mega-batch followed, the
  same gap, the worst leaf.
* ``update1_units``: the first update's norm by unit, as the model family
  splits it (``update_units``; the XML MLP's hidden unit: W1's column,
  b1's element and W2's row), the gap over the reference's norm; the
  median unit. A ReLU that rounding flips for a sample moves one or two
  units' updates by more than computing in TF32 moves all of them; the
  median unit reads the latter (PERF.md gives the readings).

Leaves whose first update in the reference is under a thousandth of the
median leaf's move by rounding alone and are left out of both.

The trajectory (:class:`Trajectory`) and its leaf norms are the same for
every model family: the harness fills one from the program's run, the
family's reference the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Trajectory:
    """What a run of the first mega-batches produced."""

    losses: list = field(default_factory=list)       # train loss a mega-batch
    decisions: list = field(default_factory=list)    # u, b, lr, alphas, n_rounds
    update1: dict = field(default_factory=dict)      # leaf -> ||global_1 - sum(alphas) w0||
    update1_units: list = field(default_factory=list)  # the same by hidden unit
    change: dict = field(default_factory=dict)       # leaf -> ||global_n - w0||


def leaf_norms(tree: dict, base: dict, scale: float = 1.0) -> dict:
    """{leaf: ||tree - scale * base||_2}, in f64."""
    return {k: torch.linalg.vector_norm(tree[k].double() - scale * base[k].double()).item()
            for k in tree}


def weight_sum(alphas) -> float:
    """sum_i alpha_i as the merge applies them (each rounded to f32)."""
    return float(np.asarray(alphas, np.float32).astype(np.float64).sum())


def norm_gaps(got: dict, want: dict, moved: dict) -> dict:
    """{leaf: |‖got‖ - ‖want‖| / max(‖want‖, median leaf's ‖want‖)}, over
    the leaves that ``moved`` (the reference's first update) shows
    moving."""
    med = float(np.median(list(moved.values())))
    keys = [k for k in want if moved[k] >= 1e-3 * med]
    scale = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], scale, 1e-300) for k in keys}


def decision_mismatches(got: list, want: list, keys=("u", "n_rounds", "b", "lr")) -> int:
    """Mega-batches whose decisions differ (a missing one counts)."""
    bad = abs(len(got) - len(want))
    for g, w in zip(got, want):
        bad += any(g[k] != w[k] for k in keys if k in g and k in w)
    return bad


def readings(got, want) -> dict:
    """The compared numbers of trajectory ``got`` against ``want`` (both
    :class:`Trajectory`s)."""
    units = np.abs(np.subtract(got.update1_units, want.update1_units)) \
        / np.maximum(want.update1_units, 1e-300)
    return {
        "loss": max(abs(g - w) / abs(w) for g, w in zip(got.losses, want.losses)),
        "update1": max(norm_gaps(got.update1, want.update1, want.update1).values()),
        "change": max(norm_gaps(got.change, want.change, want.update1).values()),
        "update1_units": float(np.median(units)),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every value finite and within its limit, {name: {value, limit}}). A
    number with no limit, or a leaf left out, is not judged."""
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])}
              for k in limits if k in values}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
