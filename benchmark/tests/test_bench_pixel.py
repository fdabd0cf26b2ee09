"""The cell ``envelope-pixel.wide`` rehearsed on the CPU at a tiny size, as
``test_bench_rehearsal.py`` rehearses the others: a tiny twin of the cell
(traffic ``pixel-2048-tiny``, the real cell's configuration and limits) in a
copy of the benchmark; ``correct`` true for the program as it is, false for
the control and for each fault a PER training cell can have; the traced run;
the cell's four readers on a made-up stretch and on the twin's profiled one.

    python -m pytest benchmark/tests/test_bench_pixel.py -q
"""

import json
import shutil

import pytest
import torch
from conftest import ROOT

from benchmark import check, faults, harness
from benchmark.stretch import Stretch

CELL = "envelope-pixel.wide"
CPU = torch.device("cpu")
SEED = 2**33 + 23  # more than 32 bits, as a run's seed may be
# the twin's traffic: the real cell's shape (the second iteration learns first, PER) at 4 envs; every run
# drives the program to its first target copy, 200 iterations in
TINY = {"num_envs": 4, "gradient_updates": 1, "batch_size": 4, "buffer_size": 256, "per": True, "learning_starts": 8,
        "profile_iters": 2}
READERS = ("kernels.conv_roofline_pct", "pixel.step_mfu", "env.frames_ms", "actor.trunk_ms")


@pytest.fixture(scope="module")
def pixel_root(tmp_path_factory):
    """A copy of the benchmark with the twin ``envelope-pixel.wide.tiny``."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    (root / "benchmark" / "traffic" / f"{w['traffic']}-tiny.json").write_text(json.dumps(TINY))
    spec["workloads"].append(dict(w, name=f"{CELL}.tiny", traffic=f"{w['traffic']}-tiny"))
    shutil.copy(root / "benchmark" / "limits" / f"{CELL}.json", root / "benchmark" / "limits" / f"{CELL}.tiny.json")
    for m in spec["per_layer"] + spec["end_to_end"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(f"{CELL}.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root, trace=False):
    return harness.run_cell(root, f"{CELL}.tiny", SEED, 0.3, trace, CPU, harness.process_start())


def test_the_cell_reads_its_files():
    c = harness.load_cell(ROOT, CELL)
    read = lambda sub, name: json.loads((ROOT / "benchmark" / sub / f"{name}.json").read_text())  # noqa: E731
    assert (c.config, c.traffic) == (read("configs", "envelope-pixel"), read("traffic", "pixel-2048"))
    assert c.chips == 1 and c.traffic["per"]
    assert {m["name"] for m, k in c.metrics if k == "end_to_end"} == {"env_steps_per_s", "setup_s"}
    assert {m["name"] for m, k in c.metrics if k == "per_layer"} == set(READERS)


def test_rehearsal(pixel_root):
    result, lines = run(pixel_root)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0, result["check"]
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert set(result["check"]) == set(json.loads((ROOT / "benchmark/limits" / f"{CELL}.json").read_text()))
    assert all(line.startswith("[check] ") for line in lines[-len(result["check"]):])


def test_traced_rehearsal(pixel_root):
    """On the CPU the trace holds no device time: of the cell's per-layer
    metrics only ``pixel.step_mfu`` (the host's clock) is read."""
    result, _ = run(pixel_root, trace=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"pixel.step_mfu"} and result["metrics"]["pixel.step_mfu"]["value"] > 0


def test_the_control_is_not_correct(pixel_root):
    c = harness.load_cell(pixel_root, f"{CELL}.tiny")
    control = harness.reference_readings(c, SEED, CPU, "tf32")
    gaps = check.compare(control, harness.reference_readings(c, SEED, CPU, draws=control.drawn))
    assert not check.verdict(gaps, c.limits), gaps


@pytest.mark.parametrize("fault", faults.FAULTS + ("sampler",))
def test_a_fault_in_the_program_is_not_correct(pixel_root, fault):
    with faults.planted(fault):
        result, _ = run(pixel_root)
    assert result["correct"] is False


def _window(stretch, gemms=None):
    peaks = json.loads((ROOT / "benchmark/peaks.json").read_text())
    return harness.Window(iters=2, wall_s=1.0, intervals_ms=[1.0, 2.0], num_envs=4, setup_s=1.0, stretch=stretch,
                          gemms=gemms, peaks=peaks)


class _Work(list):
    trunk: list


def test_readers_on_a_made_up_stretch():
    # two iterations in a 1 s window: two env steps with 3 and 1 frame spans, two act trunks
    host = [("actor.act", 0.0, 0.1), ("qnet.trunk", 0.01, 0.05), ("env.step", 0.1, 0.3), ("env.frames", 0.1, 0.12),
            ("env.frames", 0.15, 0.2), ("env.frames", 0.25, 0.28),
            ("actor.act", 0.5, 0.6), ("qnet.trunk", 0.5, 0.52), ("env.step", 0.6, 0.7), ("env.frames", 0.6, 0.62)]
    device = [("conv", 0.0, 0.25), ("k", 0.5, 0.25)]  # 0.5 s of device time
    work = _Work([(1000, 1000, 1000)])
    work.trunk = [(67e9, 1.0), (1.0, 3.35e9)]  # 1 ms bound by compute, 1 ms by bandwidth, an iteration
    win = _window(Stretch(iters=2, window_s=1.0, device_ops=device, host_ops=host), work)
    got = {name: harness.reader(ROOT, name)(win) for name in READERS}
    # by hand: (0.02 + 0.05 + 0.03 + 0.02) s of frames over 2 steps; trunks (0.04 + 0.02) / 2;
    # 2 ms an iteration over 0.5 s of device time; 2e9 operations 2 times in 1 s against 67e12
    assert got == pytest.approx({"env.frames_ms": 60.0, "actor.trunk_ms": 30.0,
                                 "kernels.conv_roofline_pct": 100 * 0.004 / 0.5, "pixel.step_mfu": 100 * 4e9 / 67e12})


def test_readers_read_nothing_on_the_parent_s_stretch():
    """A stretch without the new spans and GEMMs without trunk operations (the
    parent's program, the minecart cells): no reading, and no exception."""
    s = Stretch(iters=2, window_s=1.0, device_ops=[("k", 0.0, 0.1)], host_ops=[("env.step", 0.1, 0.2)])
    got = {name: harness.reader(ROOT, name)(_window(s, [(8, 8, 8)])) for name in READERS}
    assert got == {"env.frames_ms": None, "actor.trunk_ms": None, "kernels.conv_roofline_pct": None,
                   "pixel.step_mfu": pytest.approx(100 * 2 * 512 * 2 / 67e12)}
    assert all(harness.reader(ROOT, name)(_window(None)) is None for name in READERS)


def test_the_twin_s_stretch_holds_the_spans(pixel_root):
    """The twin profiled on the CPU as the traced run profiles it: an act
    trunk an iteration and three in each (eager) update, the frame spans of
    each env step; each reader reads them once the stretch has device operations."""
    c = harness.load_cell(pixel_root, f"{CELL}.tiny")
    agent, state, _, _ = harness.program_setup(c, SEED, CPU)
    iters = c.traffic["profile_iters"]
    s = harness.profile_stretch(agent, state, iters, CPU)
    names = [n for n, _, _ in s.host_ops]
    assert names.count("qnet.trunk") == iters * (1 + 3 * c.traffic["gradient_updates"])
    assert names.count("env.frames") == iters * 15 and names.count("env.step") == iters
    s.device_ops = [("k", 0.0, 1e-3)]
    win = _window(s, harness.algorithm(c.config["algorithm"]).gemms(c.config, c.traffic))
    assert all(harness.reader(ROOT, name)(win) > 0 for name in READERS)
