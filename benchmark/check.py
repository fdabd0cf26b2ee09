"""The comparison that decides ``correct``: the program's first three learning
iterations against the reference's, from the same seed, weights and random stream.

The numbers; a cell holds those its ``benchmark/limits/<cell>.json`` gives a limit:

- ``loss_gap``: the largest |L_program - L_reference| / |L_reference| over the
  three iterations, L being the last update's loss of the iteration;
  ``first_loss_gap`` the same of the first iteration alone;
- ``moment_gap``: after the first learning iteration, the worst leaf's gap
  between the norms of Adam's first moment, program against reference, over
  the larger of that leaf's reference norm and the median leaf's;
- ``change_gap``: the same, of each leaf's change over the three iterations,
  leaving out the leaves whose reference first moment is under a thousandth
  of the median leaf's (they move by round-off alone); ``first_change_gap``
  the same, of the change over the first learning iteration alone: Adam's
  updates themselves, before an action decided the other way on a near tie
  can move the later iterations;
- with PER, ``prio_gap``: the median, over the rows either side's first
  learning iteration gave a priority, of the relative distance of the
  program's priority from the reference's (for a row drawn twice in one
  batch, from the nearest of the values written to it: either may land last);
  ``sample_gap``: the share of the program's drawn rows that the inverse CDF
  of its live priorities at its own uniforms does not give;
- the target copy, read by the program's run alone (``harness.CopyProbe``):
  ``copy_gap``, the largest |target - online| over the leaves after the first
  iteration whose count is a multiple of ``target_net_update_freq``, and
  ``copy_timing``, the share of the target's leaves that left the run's
  starting weights before that iteration or still hold them after it;
- under the Polyak rule (a target that moves a share ``tau`` of the way to
  the online net on every update), ``target_change_gap``: the worst target
  leaf's gap between the norms of its change over the three iterations,
  program against reference, over the larger of that leaf's reference norm
  and the median target leaf's (the online leaves' median would hide a
  target that moves ``tau`` times less).

An iteration makes several Adam steps, so the first moment after one
iteration is what the optimizer's state gives in place of the first gradient.
"""

from __future__ import annotations

import statistics

NUMBERS = ("loss_gap", "first_loss_gap", "moment_gap", "change_gap", "first_change_gap", "prio_gap", "sample_gap",
           "copy_gap", "copy_timing", "target_change_gap")


class Readings:
    """What one side gives: the losses of the three learning iterations, each
    leaf's first-moment norm and change norm after the first, each leaf's
    change norm after the third and, under the Polyak rule, each target
    leaf's change norm after the third."""

    def __init__(self):
        self.losses: list[float] = []
        self.moment: dict[str, float] = {}
        self.first_change: dict[str, float] = {}
        self.change: dict[str, float] = {}
        self.target_change: dict[str, float] = {}  # the Polyak rule's target leaves; empty under the copy rule
        # with PER: the least and the largest priority each row may hold after the first learning iteration
        self.priorities = None
        self.drawn: list = []  # with PER: the rows each update drew, in order
        self.misdrawn = 0  # with PER: drawn rows that the inverse CDF of the live priorities does not give


def _norms(tensors: dict) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def record_moment(readings: Readings, moments: dict) -> None:
    readings.moment = _norms(moments)


def change_norms(before: dict, after: dict) -> dict:
    return _norms({k: after[k] - before[k] for k in before})


def _worst_leaf(prog: dict, ref: dict, leaves) -> float:
    floor = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves)


def compare(prog: Readings, ref: Readings) -> dict:
    """The numbers, program against reference."""
    if len(prog.losses) != len(ref.losses) or set(prog.moment) != set(ref.moment):
        raise ValueError("the two sides' readings do not pair up")
    rel = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    moved = [k for k in ref.moment if ref.moment[k] >= 1e-3 * statistics.median(ref.moment.values())]
    gaps = {
        "loss_gap": max(rel),
        "first_loss_gap": rel[0],
        "moment_gap": _worst_leaf(prog.moment, ref.moment, ref.moment),
        "change_gap": _worst_leaf(prog.change, ref.change, moved),
        "first_change_gap": _worst_leaf(prog.first_change, ref.first_change, moved),
    }
    if prog.target_change and ref.target_change:
        gaps["target_change_gap"] = target_change_gap(prog.target_change, ref.target_change)
    if prog.priorities is not None and ref.priorities is not None:
        import torch

        p = prog.priorities[1].double()
        lo, hi = (x.double() for x in ref.priorities)
        # stored rows enter at the running maximum, 1 before the first update; empty rows hold 0
        touched = ((p != 1.0) | (hi != 1.0)) & ((p > 0) | (hi > 0))
        gap = torch.maximum(lo - p, p - hi).clamp(min=0.0)[touched] / hi[touched].clamp(min=1e-12)
        gaps["prio_gap"] = float(torch.median(gap)) if gap.numel() else 0.0
        gaps["sample_gap"] = prog.misdrawn / max(sum(d.numel() for d in prog.drawn), 1)
    return gaps


def target_change_gap(prog: dict, ref: dict) -> float:
    """The worst target leaf's gap of change norms, over the larger of its
    reference norm and the median target leaf's."""
    if set(prog) != set(ref):
        raise ValueError("the two sides' target leaves do not pair up")
    return _worst_leaf(prog, ref, ref)


def copy_gaps(before: list, after: list, online: list, start: list) -> dict:
    """The target copy's numbers from the target's leaves just before and
    just after the copy iteration, the online net's after it, and the
    weights the run started from (device tensors; read after the window)."""
    import torch

    moved_before = [(b != s).any() for b, s in zip(before, start)]
    held_after = [(a == s).all() for a, s in zip(after, start)]
    return {
        "copy_gap": float(torch.stack([(a - o).abs().max() for a, o in zip(after, online)]).max()),
        "copy_timing": float(torch.stack(moved_before + held_after).float().sum()) / len(start),
    }


def verdict(gaps: dict, limits: dict) -> bool:
    """True when every number the cell holds (a key of ``limits``) is finite and within its limit."""
    return all(gaps[k] == gaps[k] and gaps[k] <= limit for k, limit in limits.items())
