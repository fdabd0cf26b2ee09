"""Faults planted in the program, to show that the check catches each kind a
training cell can have.  Each is a context manager that patches the program's
classes and restores them on exit.

- ``frozen``: a step that returns its state unchanged (Adam's step does nothing);
- ``stuck``: Adam's state advances and the parameters stay where they were;
- ``half``: half of the batch left out, the mean taken over the rest (the
  sampled rows' second half replaced by the first);
- ``action``: an answer altered where it is produced (every greedy action
  shifted to the next one);
- ``sampler`` (PER cells): the prioritized draw made uniform over the stored rows;
- ``nocopy``: the target copy does nothing.

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


def planted(fault: str):
    """A context manager under which the program runs with ``fault``."""
    if fault == "frozen":
        return _patched(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)
    if fault == "stuck":

        def make(orig):
            def step(self, closure=None):
                kept = [p.detach().clone() for g in self.param_groups for p in g["params"]]
                orig(self, closure)
                with torch.no_grad():
                    for p, k in zip([p for g in self.param_groups for p in g["params"]], kept):
                        p.copy_(k)

            return step

        return _patched(torch.optim.Adam, "step", make)
    if fault == "nocopy":
        from morl_baselines_torch.agents import envelope, gpils

        stack = contextlib.ExitStack()
        for module in (envelope, gpils):
            stack.enter_context(_patched(module, "polyak_update", lambda orig: lambda net, target, tau: None))
        return stack
    if fault == "half":
        from morl_baselines_torch.replay.buffer import ReplayBuffer

        def make(orig):
            def gather(self, idx):
                h = idx.shape[0] // 2
                return orig(self, torch.cat([idx[:h], idx[:h], idx[2 * h :]]))

            return gather

        return _patched(ReplayBuffer, "gather", make)
    if fault == "action":
        from morl_baselines_torch.agents import GPILS, Envelope

        stack = contextlib.ExitStack()
        for owner, name in ((Envelope, "_greedy_actions"), (GPILS, "_gpi_actions")):
            stack.enter_context(_patched(owner, name, lambda orig: lambda self, *a: (orig(self, *a) + 1) % self.env.num_actions))
        return stack
    if fault == "sampler":
        from morl_baselines_torch.replay.prioritized import PrioritizedReplayBuffer

        def make(orig):
            def sample_at(self, u):
                idx = (u * self.size).long()
                return self.gather(idx), idx, torch.full_like(u, 1.0 / self.size)

            return sample_at

        return _patched(PrioritizedReplayBuffer, "sample_at", make)
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
