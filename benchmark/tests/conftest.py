"""Fixtures of the benchmark's CPU tests: the checkout's root on ``sys.path``,
and a temporary checkout whose BENCHMARK.json adds tiny cells on the CPU.

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each real cell's traffic at a size a CPU test holds; the limits are the real cell's
TINY = {
    "wide-32768": {"num_envs": 64, "gradient_updates": 2, "batch_size": 32, "buffer_size": 1024, "per": False, "learning_starts": 64},
    "proto": {"num_envs": 16, "gradient_updates": 8, "batch_size": 64, "buffer_size": 4096, "per": True, "learning_starts": 256},
    "wide-4096": {"num_envs": 32, "gradient_updates": 2, "batch_size": 32, "buffer_size": 1024, "per": False, "learning_starts": 32},
}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark in which every cell ``<name>`` whose traffic
    ``TINY`` shrinks has a tiny twin ``<name>.tiny`` (traffic
    ``<traffic>-tiny``, the real cell's limits)."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in [w for w in spec["workloads"] if w["traffic"] in TINY]:
        tiny = dict(TINY[w["traffic"]], profile_iters=2)
        (root / "benchmark" / "traffic" / f"{w['traffic']}-tiny.json").write_text(json.dumps(tiny))
        name = f"{w['name']}.tiny"
        spec["workloads"].append(dict(w, name=name, traffic=f"{w['traffic']}-tiny"))
        shutil.copy(root / "benchmark" / "limits" / f"{w['name']}.json", root / "benchmark" / "limits" / f"{name}.json")
        for m in spec["per_layer"] + spec["end_to_end"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
