"""Each cell rehearsed on the CPU at a tiny size, against the plain reference:
the result line's keys, ``correct`` true for the program as it is, and false
for the control and for each fault a training cell can have."""

import json

import pytest
import torch
from conftest import ROOT, TINY

from benchmark import check, faults, harness

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"] if w["traffic"] in TINY]
CPU = torch.device("cpu")
SEED = 2**33 + 17  # more than 32 bits, as a run's seed may be


def run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(root, f"{cell}.tiny", seed, 0.3, trace, CPU, harness.process_start())


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(tiny_root, cell, capsys):
    result, lines = run(tiny_root, cell)
    print(json.dumps(result))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m, kind in harness.load_cell(ROOT, cell).metrics if kind == "end_to_end"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["check"]) == set(harness.load_cell(ROOT, cell).limits)
    assert all(line.startswith("[check] ") for line in lines[-len(result["check"]):])


def test_traced_rehearsal(tiny_root):
    """The traced path end to end; on the CPU the trace holds no device time,
    so only ``step_mfu`` and ``loop.iter_ms_p95`` are read (by the host's
    clock on the CPU, printed only here)."""
    result, _ = run(tiny_root, "gpils-minecart.proto", trace=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"step_mfu", "loop.iter_ms_p95"}
    assert {"busy_s", "window_s"} <= set(result["device"]) and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", ["envelope-minecart.wide", "gpils-minecart.proto"])
def test_a_fault_in_the_program_is_not_correct(tiny_root, cell, fault):
    with faults.planted(fault):
        result, _ = run(tiny_root, cell)
    assert result["correct"] is False


def test_a_wrong_prioritized_draw_is_not_correct(tiny_root):
    with faults.planted("sampler"):
        result, _ = run(tiny_root, "gpils-minecart.proto")
    assert result["correct"] is False and result["check"]["sample_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    """The reference with TF32 operands in the program's place fails a limit."""
    c = harness.load_cell(tiny_root, f"{cell}.tiny")
    control = harness.reference_readings(c, SEED, CPU, "tf32")
    gaps = check.compare(control, harness.reference_readings(c, SEED, CPU, draws=control.drawn if c.traffic["per"] else None))
    assert not check.verdict(gaps, c.limits), gaps


def test_tf32_rounding():
    from benchmark.reference.common import round_tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10 + 2**-12, -3.0])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, -3.0]


def test_a_row_drawn_twice_may_keep_either_priority():
    """The reference keeps the last of a row's new priorities and the range of
    them; a program that kept any of them reads no gap on that row."""
    from benchmark.reference.common import Replay

    buf = Replay(8, 2, 1, CPU, per=True)
    buf.add(torch.zeros(6, 2), torch.zeros(6), torch.zeros(6, 1), torch.zeros(6, 2), torch.zeros(6))
    buf.set_priorities(torch.tensor([1, 1, 1]), torch.tensor([0.5, 0.25, 0.75]))
    assert buf.prio[:6].tolist() == [1.0, 0.75, 1.0, 1.0, 1.0, 1.0]
    assert buf.prio_lo[:6].tolist() == [1.0, 0.25, 1.0, 1.0, 1.0, 1.0]
    assert buf.prio_hi[:6].tolist() == [1.0, 0.75, 1.0, 1.0, 1.0, 1.0]
    ref, prog = check.Readings(), check.Readings()
    ref.priorities = (buf.prio_lo, buf.prio_hi)
    for side in (prog, ref):
        side.losses, side.moment, side.first_change, side.change = [1.0], {"a": 1.0}, {"a": 1.0}, {"a": 1.0}
    for kept, gap in ((0.25, 0.0), (0.5, 0.0), (0.75, 0.0), (0.9, 0.2), (0.15, 0.1 / 0.75)):
        p = buf.prio.clone()
        p[1] = kept
        prog.priorities = (p, p)
        assert check.compare(prog, ref)["prio_gap"] == pytest.approx(gap)


def test_target_copy_numbers():
    start = [torch.zeros(3), torch.zeros(2)]
    online = [torch.ones(3), torch.full((2,), 2.0)]
    sound = check.copy_gaps(start, online, online, start)
    assert sound == {"copy_gap": 0.0, "copy_timing": 0.0}
    never = check.copy_gaps(start, start, online, start)
    assert never["copy_gap"] == 2.0 and never["copy_timing"] == 1.0
    early = check.copy_gaps([start[0], online[1]], online, online, start)
    assert early == {"copy_gap": 0.0, "copy_timing": 0.5}
    reversed_copy = check.copy_gaps(start, start, start, start)  # the online net took the target's weights
    assert reversed_copy == {"copy_gap": 0.0, "copy_timing": 1.0}
