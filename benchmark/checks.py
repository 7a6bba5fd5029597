"""The comparison that decides ``correct`` for a training cell.

Three numbers, each a gap between the program and the plain reference over
the first three steps, from the same start, on the same batches:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's change of each leaf (what the optimizer
  applied, the gradient's step), by the worst leaf;
* ``change_gap``: each leaf's change after the three steps, by the worst
  leaf.

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of the
reference's norm of that leaf and of the median leaf. A leaf whose
reference norm is under a thousandth of the median leaf's moves by rounding
alone and is left out of that number. A cell's limits may leave a number
out (``None``) where no control or fault moves it; it is then not
compared.
"""

from __future__ import annotations

import math
import statistics

import torch

NAMES = ("loss_gap", "grad_gap", "change_gap")
LEAF_FLOOR = 1e-3


def change_norms(states: list[dict], weights0: dict, step: int) -> dict:
    """Each leaf's norm of its change from ``weights0`` after ``step``
    steps (``states[k]`` is the state after ``k + 1`` steps)."""
    out = {}
    for k, w in weights0.items():
        s = states[step - 1][k].to(w.device, torch.float64)
        out[k] = float(torch.linalg.vector_norm(s - w.to(torch.float64)))
    return out


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap of norms (see the module's docstring)."""
    med = statistics.median(ref.values())
    gaps = [abs(prog[k] - r) / max(r, med) for k, r in ref.items()
            if r >= LEAF_FLOOR * med and max(r, med) > 0]
    return max(gaps) if gaps else math.inf


def readings(prog: dict, ref: dict, weights0: dict) -> dict:
    """The three numbers; ``prog`` and ``ref`` hold ``losses`` (one a step)
    and ``states`` (each leaf after every step); the program's states may
    be only those after steps 1 and 3, under ``states_at`` ``(1, 3)``."""
    p_at = prog.get("states_at", tuple(range(1, len(prog["states"]) + 1)))
    p_states = {n: s for n, s in zip(p_at, prog["states"])}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    loss = max(gaps) if all(map(math.isfinite, gaps)) else math.inf
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    out = {"loss_gap": loss}
    for name, step in (("grad_gap", 1), ("change_gap", 3)):
        pn = change_norms([p_states[step]], weights0, 1)
        rn = change_norms(ref["states"], weights0, step)
        out[name] = leaf_gap(pn, rn)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def compared(limits: dict) -> list[str]:
    """The numbers a cell compares: those its limits do not leave out
    (a limit of ``None``)."""
    return [k for k in NAMES if limits.get(k) is not None]


def judge(values: dict, limits: dict) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in compared(limits))
