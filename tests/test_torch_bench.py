"""The port's throughput bench (``morl_baselines_torch/cli/bench.py``) against
the JAX package's ``bench.py``.

``bench.py`` is read with ``ast`` and never imported (importing it points
JAX's compilation cache into the repository).  Its workload order, metric
names, ``unit`` strings and ``REFERENCE_SPS`` must equal the port's, and
every literal of each workload function, evaluated in both size branches
(``x if on_accel else y`` with ``on_accel`` true and false), must appear in
the port's function with the same pair of values; a mutated literal in a
copy of the port is caught.  Then the bench runs on the CPU at its CPU sizes.
"""

import ast
import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from morl_baselines_torch.cli import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_BENCH = ROOT / "bench.py"
PORT_BENCH = Path(bench.__file__)
WORKLOADS = [
    "bench_gpils_minecart",
    "bench_gpils_cont_hopper",
    "bench_pgmorl_halfcheetah",
    "bench_morld_halfcheetah",
    "bench_pareto_kernel",
    "bench_envelope_minecart",
]
ALIASES = {"make_env": "make"}  # the port's make, with the planar envs' constants on the run's device
LITERAL = (bool, int, float, str, tuple, type(None))
# (JAX context, key) -> the port's spelling of the same literal, None where the port has none:
# the seeds of jax.random.key go to init_state (or the points' generator); the JAX
# population's key split and stacked buffers become range(pop) seeds and make_buffer(pop)
KEY_SEED = {("key", "arg0"): ("init_state", "arg0")}
TRANSLATE = {
    "bench_gpils_minecart": {**KEY_SEED, ("train_segment", "arg3"): None},  # support_cap, not ported
    "bench_gpils_cont_hopper": KEY_SEED,
    "bench_morld_halfcheetah": {
        ("key", "arg0"): None,  # the split key (seeds 0..5 in the port) and _pop_step's key (the state's generator)
        ("split", "arg1"): ("range", "arg0"),
        ("repeat", "arg1"): ("make_buffer", "arg0"),
        ("repeat", "axis"): None,
    },
    "bench_pareto_kernel": {
        ("key", "arg0"): ("manual_seed", "arg0"),
        ("normal", "arg1"): ("randn", "arg0"),
        ("non_dominated_mask_pallas", "keep_duplicates"): ("non_dominated_mask_cuda", "keep_duplicates"),
    },
    "bench_envelope_minecart": KEY_SEED,
}


def _name(call: ast.Call) -> str:
    f = call.func
    n = f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else ""
    return ALIASES.get(n, n)


def _eval(node, names: dict):
    code = compile(ast.Expression(node), "<bench>", "eval")
    return eval(code, {"__builtins__": {}, "max": max, **names})


def _literals(fn: ast.FunctionDef) -> Counter:
    """Counter of (context, key, (accel value, CPU value)) for every local,
    call keyword, positional call argument and dict entry of ``fn`` whose
    value is computable from literals, ``on_accel`` and earlier locals."""
    envs = []
    for on_accel in (True, False):
        names = {"on_accel": on_accel}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
                try:
                    names[node.targets[0].id] = _eval(node.value, names)
                except Exception:
                    pass  # not a literal: env, agent, a device tensor...
        envs.append(names)
    out = Counter()
    for node in ast.walk(fn):
        items = []
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            items.append((("local", node.targets[0].id), node.value))
        elif isinstance(node, ast.Call):
            items += [((_name(node), kw.arg), kw.value) for kw in node.keywords if kw.arg]
            items += [((_name(node), f"arg{i}"), a) for i, a in enumerate(node.args)]
        elif isinstance(node, ast.Dict):
            items += [(("dict", k.value), v) for k, v in zip(node.keys, node.values) if isinstance(k, ast.Constant)]
        for key, v in items:
            try:
                val = tuple(_eval(v, e) for e in envs)
            except Exception:
                continue
            if all(isinstance(x, LITERAL) for x in val):
                out[key + (val,)] += 1
    return out


def _functions(path: Path) -> dict:
    return {n.name: n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef)}


def _reference_sps(path: Path) -> float:
    tree = ast.parse(path.read_text())
    return next(n.value.value for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "REFERENCE_SPS")


def _jax_suite() -> list:
    main = _functions(JAX_BENCH)["main"]
    first = next(n for n in ast.walk(main) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "suite")
    return [e.id for e in first.value.elts]


def _port_suite(path: Path) -> list:
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "SUITE")
    return [e.id for e in node.value.elts]


def mismatches(port: Path) -> list:
    """Every way the port's bench at ``port`` departs from ``bench.py``."""
    out = []
    if _port_suite(port) != _jax_suite():
        out.append(f"workload order {_port_suite(port)} != {_jax_suite()}")
    if _reference_sps(port) != _reference_sps(JAX_BENCH):
        out.append(f"REFERENCE_SPS {_reference_sps(port)} != {_reference_sps(JAX_BENCH)}")
    jax_fns, port_fns = _functions(JAX_BENCH), _functions(port)
    for name in ["_emit", *WORKLOADS]:
        got = _literals(port_fns[name])
        want = Counter()
        for (ctx, key, val), count in _literals(jax_fns[name]).items():
            to = TRANSLATE.get(name, {}).get((ctx, key), (ctx, key))
            if to is not None:
                want[to + (val,)] += count
        missing = want - got
        if missing:
            out.append(f"{name}: the port lacks {sorted(missing, key=repr)}")
    return out


def test_workload_order_equals_jax_headline_last():
    assert _port_suite(PORT_BENCH) == _jax_suite() == WORKLOADS
    assert [f.__name__ for f in bench.SUITE] == WORKLOADS


def test_reference_sps_equals_jax():
    assert bench.REFERENCE_SPS == _reference_sps(JAX_BENCH) == 1000.0


@pytest.mark.parametrize("name", ["_emit", *WORKLOADS])
def test_literals_equal_jax(name):
    """Metric names, units and every literal of both size branches."""
    want = _literals(_functions(JAX_BENCH)[name])
    assert len(want) >= 3, want
    assert not [m for m in mismatches(PORT_BENCH) if m.startswith(f"{name}:")]


MUTATIONS = [
    ("num_envs = 4096 if on_accel else 32", "num_envs = 4096 if on_accel else 33"),
    ("iters = 100 if on_accel else 20", "iters = 100 if on_accel else 10"),
    ("seg_iters = 32 if on_accel else 2", "seg_iters = 16 if on_accel else 2"),
    ("n = 8192 if on_accel else 512", "n = 4096 if on_accel else 512"),
    ("max_support=16,", "max_support=8,"),
    ("num_sample_w=4,", "num_sample_w=2,"),
    ("bf16_act=on_accel,", "bf16_act=False,"),
    ("equally_spaced_weights(env.reward_dim, 8)", "equally_spaced_weights(env.reward_dim, 4)"),
    ("sac=MOSACConfig(num_envs=num_envs, learning_starts=num_envs, buffer_size=16384)",
     "sac=MOSACConfig(num_envs=num_envs, learning_starts=num_envs, buffer_size=8192)"),
    ('"unit": "env-steps/s/chip"', '"unit": "env-steps/s"'),
    ('"unit": "rows/s"', '"unit": "row/s"'),
    ('"gpils_cont_hopper_env_steps_per_sec_per_chip"', '"gpils_cont_hopper_steps_per_sec_per_chip"'),
    ("REFERENCE_SPS = 1000.0", "REFERENCE_SPS = 100.0"),
    ("    bench_pareto_kernel,\n    bench_envelope_minecart,", "    bench_envelope_minecart,\n    bench_pareto_kernel,"),
]


@pytest.mark.parametrize("old,new", MUTATIONS, ids=[f"m{i}" for i in range(len(MUTATIONS))])
def test_mutated_literal_is_caught(tmp_path, old, new):
    src = PORT_BENCH.read_text()
    assert src.count(old) >= 1, old
    mutated = tmp_path / "bench.py"
    mutated.write_text(src.replace(old, new, 1))
    assert mismatches(mutated), f"{old!r} -> {new!r} not caught"


def _lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_cpu_sizes_print_six_lines(capsys):
    """``--device cpu``: six parseable lines at bench.py's CPU sizes, headline last."""
    assert bench.main(["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    lines = _lines(cap.out)
    assert [r["metric"] for r in lines] == [
        "gpils_minecart_env_steps_per_sec_per_chip",
        "gpils_cont_hopper_env_steps_per_sec_per_chip",
        "pgmorl_halfcheetah_env_steps_per_sec_per_chip",
        "morld_halfcheetah_env_steps_per_sec_per_chip",
        "pareto_nd_mask_n512_rows_per_sec",
        "envelope_minecart_env_steps_per_sec_per_chip",
    ]
    for r in lines:
        assert set(r) == {"metric", "value", "unit", "vs_baseline"}
        assert r["value"] > 0
    assert [r["unit"] for r in lines] == ["env-steps/s/chip"] * 4 + ["rows/s", "env-steps/s/chip"]
    assert lines[4]["vs_baseline"] == 1.0
    assert lines[0]["vs_baseline"] == round(lines[0]["value"] / bench.REFERENCE_SPS, 2)
    assert cap.err.count("[bench] repetitions: ") == 6


def test_headline_only(monkeypatch, capsys):
    ran = []
    for name in WORKLOADS[:-1]:
        monkeypatch.setattr(bench, name, lambda *a, _n=name: ran.append(_n))
    monkeypatch.setattr(bench, "SUITE", tuple(getattr(bench, n) for n in WORKLOADS))
    assert bench.main(["--headline-only", "--device", "cpu"]) == 0
    assert ran == []
    assert [r["metric"] for r in _lines(capsys.readouterr().out)] == ["envelope_minecart_env_steps_per_sec_per_chip"]


def test_raising_workload_lets_the_others_print(monkeypatch, capsys):
    def broken(on_accel, device):
        raise RuntimeError("broken workload")

    monkeypatch.setattr(bench, "SUITE", (broken, bench.bench_pareto_kernel, bench.bench_envelope_minecart))
    assert bench.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert [r["metric"] for r in _lines(cap.out)] == [
        "pareto_nd_mask_n512_rows_per_sec", "envelope_minecart_env_steps_per_sec_per_chip",
    ]
    assert "RuntimeError: broken workload" in cap.err


def test_every_call_starts_from_a_fresh_state():
    """One warm-up and 3 timed calls, each on its own state from ``fresh``."""
    built, ran = [], []

    def fresh():
        built.append(object())
        return built[-1]

    dt = bench._time(ran.append, fresh, torch.device("cpu"))
    assert dt >= 0 and len(built) == 4 and ran == built


def test_cuda_by_default_without_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda", "--headline-only"])


@pytest.mark.parametrize("module", ["bench", "profile_gpils", "profile_population", "bench_gpils_ab", "probe_planar"])
def test_imports_neither_jax_nor_scripts(module):
    tree = ast.parse((PORT_BENCH.parent / f"{module}.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0}
    banned = ("jax", "jaxlib", "flax", "morl_baselines_tpu", "scripts")
    assert not [m for m in mods if m.split(".")[0] in banned], mods
