"""BENCHMARK.json against the contract's rules, and every file the harness finds by name."""

import json
import re
import shutil
import subprocess
import sys
import types

import pytest
from conftest import ROOT

from benchmark import check, harness
from benchmark.stretch import Stretch

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"}, "workloads": {"name", "config", "traffic", "chips", "why"}}
    for kind, want in keys.items():
        for e in SPEC[kind]:
            assert set(e) == want, e
            assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.chips in (1, 4)
    algo = harness.algorithm(c.config["algorithm"])
    assert algo.gemms(c.config, c.traffic)
    assert set(c.limits) <= set(check.NUMBERS) and c.limits
    kinds = {k for _, k in c.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    e2e = {m["name"] for m, k in c.metrics if k == "end_to_end"}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(m["moves"] in e2e for m, k in c.metrics if k == "per_layer")
    for entry, _ in c.metrics:
        assert callable(harness.reader(ROOT, entry["name"]))


def test_config_files_lie_under_paths_and_name_their_changes():
    for conf in SPEC["configs"]:
        assert conf["file"].startswith("benchmark/configs/")
        body = json.loads((ROOT / conf["file"]).read_text())
        assert set(conf["reduced"]) == set(body.get("changed_from_source", {}))
        assert body["source"] == conf["source"]


def test_a_new_traffic_file_is_picked_up_without_an_edit(tiny_root):
    """The tiny cells of the fixture are a traffic file, a limits file and a
    BENCHMARK.json entry each, added to a copy: the harness finds them."""
    c = harness.load_cell(tiny_root, "envelope-minecart.wide.tiny")
    assert c.traffic["num_envs"] == 64 and c.limits == json.loads((ROOT / "benchmark/limits/envelope-minecart.wide.json").read_text())
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "envelope-minecart.wide.tiny")


def _window(**kw):
    base = dict(iters=10, wall_s=2.0, intervals_ms=[float(i) for i in range(1, 101)], num_envs=64, setup_s=12.5)
    return harness.Window(**(base | kw))


def test_end_to_end_readers():
    win = _window()
    assert harness.reader(ROOT, "env_steps_per_s")(win) == 320.0
    assert harness.reader(ROOT, "iter_ms_p95")(win) == 95.0
    assert harness.reader(ROOT, "loop.iter_ms_p95")(win) == 95.0
    assert harness.reader(ROOT, "setup_s")(win) == 12.5


def test_per_layer_readers_on_a_made_up_trace():
    # two iterations, 4 ops of 0.1 s each, two of them overlapping, in a 1 s window
    ops = [("a", 0.0, 0.1), ("b", 0.05, 0.1), ("gemm", 0.5, 0.1), ("c", 0.9, 0.2)]
    win = _window(stretch=Stretch(iters=2, window_s=1.0, device_ops=ops, host_ops=[("aten::mm", 0.2, 0.45)]),
                  gemms=[(1000, 1000, 1000)], peaks={"fp32_flops": 1e12, "hbm_bytes_per_s": 1e12})
    assert harness.reader(ROOT, "loop.launches_per_iter")(win) == 2.0
    assert harness.reader(ROOT, "device.busy_pct")(win) == pytest.approx(100 * (0.15 + 0.1 + 0.1))
    # 2e9 operations at 1e12/s = 2 ms an iteration, 2 iterations, over 0.5 s of device time
    assert harness.reader(ROOT, "kernels.roofline_pct")(win) == pytest.approx(100 * 0.004 / 0.5)
    assert harness.reader(ROOT, "step_mfu")(win) == pytest.approx(100 * 2e9 * 10 / (2.0 * 1e12))
    gaps = dict(win.stretch.idle_gaps())
    assert gaps["aten::mm"] == pytest.approx(0.35) and gaps["python"] == pytest.approx(0.3)
    assert win.stretch.top_device_ops(1) == [["c", 0.2]]


def test_readers_return_nothing_without_a_trace():
    win = _window()
    for name in ("loop.launches_per_iter", "device.busy_pct", "kernels.roofline_pct", "step_mfu"):
        assert harness.reader(ROOT, name)(win) is None


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    fake = types.SimpleNamespace(modules={"morl_baselines_torch.agents": 0, "morl_baselines_tpu_extra": 0, "jaxtyping": 0})
    monkeypatch.setattr(harness, "sys", fake)
    assert harness.forbidden_modules() == []
    fake.modules.update({"jax.numpy": 0, "morl_baselines_tpu.agents": 0, "flax": 0})
    assert harness.forbidden_modules() == ["flax", "jax", "morl_baselines_tpu"]


@pytest.mark.parametrize("alone", [False, True])
def test_no_card_or_no_program_no_result(tmp_path, alone):
    """Without a CUDA device, or in a directory holding only BENCHMARK.json and
    the benchmark, a run exits non-zero and prints nothing on stdout."""
    where = ROOT
    if alone:
        where = tmp_path
        shutil.copytree(ROOT / "benchmark", where / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", where)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gpils-minecart.proto", "--seed", str(2**33 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=where, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
