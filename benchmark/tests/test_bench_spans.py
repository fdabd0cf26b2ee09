"""The readers of the program's spans (``actor.ms_per_iter``, ``env.step_ms``,
``replay.sample_ms``, ``learner.ms_per_update``) on a made-up stretch, and the
spans as the stretch of a tiny cell profiled on the CPU holds them."""

import pytest
import torch
from conftest import ROOT

from benchmark import harness
from benchmark.stretch import Stretch

CPU = torch.device("cpu")
SEED = 2**33 + 29
READERS = ("actor.ms_per_iter", "env.step_ms", "replay.sample_ms", "learner.ms_per_update")
# two iterations in a 1 s window; the second draws and updates once more than the first
HOST = [
    ("actor", 0.0, 0.2), ("actor.act", 0.01, 0.05), ("aten::addmm", 0.02, 0.03), ("env.step", 0.05, 0.12),
    ("replay.add", 0.12, 0.15),
    ("learner", 0.2, 0.45), ("replay.sample", 0.2, 0.22), ("learner.update", 0.22, 0.32),
    ("replay.sample", 0.32, 0.34), ("learner.update", 0.34, 0.44),
    ("actor", 0.5, 0.8), ("env.step", 0.55, 0.6), ("replay.add", 0.6, 0.7),
    ("learner", 0.8, 0.99), ("replay.sample", 0.8, 0.85), ("learner.update", 0.85, 0.89),
    ("learner.target_copy", 0.99, 1.0),
]
DEVICE = [("k", 0.0, 0.05), ("k", 0.12, 0.76)]  # (name, start, duration)
# by hand: actor (0.2 + 0.3) s over 2 iterations; env.step (0.07 + 0.05) / 2; replay.sample
# (0.02 + 0.02 + 0.05) / 3; learner.update (0.1 + 0.1 + 0.04) / 3 (the ``learner`` spans are not updates)
WANT = {"actor.ms_per_iter": 250.0, "env.step_ms": 60.0, "replay.sample_ms": 30.0, "learner.ms_per_update": 80.0}


def _window(stretch):
    return harness.Window(iters=2, wall_s=1.0, intervals_ms=[1.0, 2.0], num_envs=64, setup_s=1.0, stretch=stretch)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_made_up_stretch(name):
    win = _window(Stretch(iters=2, window_s=1.0, device_ops=list(DEVICE), host_ops=list(HOST)))
    assert harness.reader(ROOT, name)(win) == pytest.approx(WANT[name])


def test_an_idle_gap_inside_a_span_is_credited_to_it():
    s = Stretch(iters=2, window_s=1.0, device_ops=list(DEVICE), host_ops=list(HOST))
    gaps = dict(s.idle_gaps())
    # 0.05-0.12 (mid 0.085 in env.step), 0.88-1.0 (mid 0.94 in the second learner)
    assert set(gaps) == {"env.step", "learner"}
    assert gaps["env.step"] == pytest.approx(0.07) and gaps["learner"] == pytest.approx(0.12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_device_ops_or_a_stretch(name):
    read = harness.reader(ROOT, name)
    assert read(_window(Stretch(iters=2, window_s=1.0, device_ops=[], host_ops=list(HOST)))) is None
    assert read(_window(None)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_where_its_span_is_absent(name):
    """The parent of the spans: a stretch of aten ops alone."""
    host = [("aten::mm", 0.1, 0.2), ("aten::add_", 0.3, 0.4), ("actor.act", 0.5, 0.6)]
    win = _window(Stretch(iters=2, window_s=1.0, device_ops=list(DEVICE), host_ops=host))
    assert harness.reader(ROOT, name)(win) is None


@pytest.mark.parametrize("cell", ["envelope-minecart.wide", "gpils-minecart.proto"])
def test_the_stretch_of_a_cell_holds_the_spans(tiny_root, cell):
    """A tiny twin of each cell, profiled on the CPU as the traced run profiles
    it: the stretch's host operations hold every span of the loop, and each
    reader reads them once the stretch has device operations."""
    c = harness.load_cell(tiny_root, f"{cell}.tiny")
    agent, state, _, _ = harness.program_setup(c, SEED, CPU)
    iters = c.traffic["profile_iters"]
    s = harness.profile_stretch(agent, state, iters, CPU)
    names = [n for n, _, _ in s.host_ops]
    per_iter = {"actor": 1, "actor.act": 1, "env.step": 1, "replay.add": 1, "learner": 1,
                "replay.sample": c.traffic["gradient_updates"], "learner.update": c.traffic["gradient_updates"],
                "replay.update_priorities": c.traffic["gradient_updates"] if c.traffic["per"] else 0}
    assert {k: names.count(k) for k in per_iter} == {k: v * iters for k, v in per_iter.items()}
    assert s.device_ops == []
    s.device_ops = [("k", 0.0, 1e-6)]
    for name in READERS:
        assert harness.reader(ROOT, name)(_window(s)) > 0
