"""Faults planted in the program, to show that the check catches each kind a
training cell can have.  Each is a context manager that patches the program's
classes and functions and restores them on exit.

- ``frozen``: a step that returns its state unchanged: the learner's step
  entries do nothing (``torch.optim.Adam.step``, and ``ops/adam_step.py``'s
  ``clip_adam_step_cuda`` and ``adam_step_plain``, which the one-seed Envelope
  and GPI-LS updates call in place of Adam's step);
- ``stuck``: the optimizer's state advances and the parameters stay where
  they were, at the same entries;
- ``half``: half of the batch left out, the mean taken over the rest (the
  sampled rows' second half replaced by the first, of a ``ReplayBuffer``'s
  gather and of each member's batch a ``MemberReplayBuffer`` samples);
- ``action``: an answer altered where it is produced: every greedy action of
  Envelope and GPI-LS shifted to the next one, and the continuous MOSAC's
  explore actions rolled by one along the action dimension (negated where the
  action has one dimension, which a roll leaves as it is);
- ``sampler`` (PER cells): the prioritized draw made uniform over the stored rows;
- ``nocopy``: the target update does nothing (``polyak_update``, a hard copy
  at tau 1, inside Envelope, GPI-LS, MOSAC and the continuous GPI-LS).

The exchange between chips has no fault here: every cell runs on one chip."""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen", "stuck", "half", "action", "nocopy")  # the kinds every training cell can have


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def _patches(*patches):
    """Every (owner, name, make) of ``patches`` at once."""
    with contextlib.ExitStack() as stack:
        for owner, name, make in patches:
            stack.enter_context(_patched(owner, name, make))
        yield


def _step_entries() -> list:
    """The learner's step entries, each called with the optimizer first."""
    from morl_baselines_torch.ops import adam_step

    return [(torch.optim.Adam, "step"), (adam_step, "clip_adam_step_cuda"), (adam_step, "adam_step_plain")]


def _frozen(orig):
    return lambda optimizer, *args, **kwargs: None


def _stuck(orig):
    def step(optimizer, *args, **kwargs):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        out = orig(optimizer, *args, **kwargs)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)
        return out

    return step


def _half_gather(orig):
    def gather(self, idx):
        h = idx.shape[0] // 2
        return orig(self, torch.cat([idx[:h], idx[:h], idx[2 * h :]]))

    return gather


def _half_members(orig):
    def sample(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)  # rows (members, batch, ...)
        h = out.obs.shape[1] // 2
        return type(out)(*(torch.cat([x[:, :h], x[:, :h], x[:, 2 * h :]], dim=1) for x in out))

    return sample


def _next_action(orig):
    return lambda self, *a: (orig(self, *a) + 1) % self.env.num_actions


def _rolled(orig):
    def explore(self, state):
        a = orig(self, state)
        return torch.roll(a, 1, dims=-1) if a.shape[-1] > 1 else -a

    return explore


def _no_target_update(orig):
    return lambda net, target, tau: None


def planted(fault: str):
    """A context manager under which the program runs with ``fault``."""
    if fault in ("frozen", "stuck"):
        make = _frozen if fault == "frozen" else _stuck
        return _patches(*[(owner, name, make) for owner, name in _step_entries()])
    if fault == "nocopy":
        from morl_baselines_torch.agents import envelope, gpils, gpils_continuous, mosac

        return _patches(*[(m, "polyak_update", _no_target_update) for m in (envelope, gpils, mosac, gpils_continuous)])
    if fault == "half":
        from morl_baselines_torch.replay.buffer import MemberReplayBuffer, ReplayBuffer

        return _patches((ReplayBuffer, "gather", _half_gather), (MemberReplayBuffer, "sample", _half_members))
    if fault == "action":
        from morl_baselines_torch.agents import GPILS, Envelope
        from morl_baselines_torch.agents.mosac import MOSAC

        return _patches((Envelope, "_greedy_actions", _next_action), (GPILS, "_gpi_actions", _next_action),
                        (MOSAC, "_explore", _rolled))
    if fault == "sampler":
        from morl_baselines_torch.replay.prioritized import PrioritizedReplayBuffer

        def make(orig):
            def sample_at(self, u):
                idx = (u * self.size).long()
                return self.gather(idx), idx, torch.full_like(u, 1.0 / self.size)

            return sample_at

        return _patched(PrioritizedReplayBuffer, "sample_at", make)
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
