"""The port's protocol runner (``morl_baselines_torch/cli/parity.py``)
against the JAX package's ``scripts/parity.py``.

The JAX runner is read with ``ast`` and never imported (importing it points
JAX's compilation cache into the repository).  Its config names must equal
the port's, and every keyword of a config function whose value is computable
from literals and ``SMOKE`` alone (``x if SMOKE else y``, ``np.array([...])``,
a local assigned from such values) must equal the port spec's value, under
``--smoke`` and at the reference budgets.  Then a few configs run through
``main`` on the CPU at their smoke budgets.
"""

import ast
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from morl_baselines_tpu.agents import nlmoppo as jnlmoppo
from morl_baselines_torch.cli import parity

torch.set_num_threads(1)

JAX_RUNNER = Path(__file__).resolve().parents[1] / "scripts" / "parity.py"
TREE = ast.parse(JAX_RUNNER.read_text())
FUNCS = {n.name: n for n in TREE.body if isinstance(n, ast.FunctionDef)}
CONFIGS = next(
    {kw.arg: kw.value.id for kw in n.value.keywords}
    for n in TREE.body
    if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "CONFIGS"
)
# numpy calls inside the JAX summaries (``axis=``, ``dtype=``), not hyperparameters
SUMMARY_CALLS = {"max", "norm", "zeros"}
# config options the port dropped with their untaken branches: the port runs the JAX default
DROPPED = {"NLMOPPOConfig": jnlmoppo.NLMOPPOConfig}


def _value(node, smoke: bool, names: dict):
    """The node's value from literals, ``SMOKE``, ``np`` and ``names``;
    raises (NameError, AttributeError...) for anything else."""
    code = compile(ast.Expression(node), str(JAX_RUNNER), "eval")
    return eval(code, {"__builtins__": {}, "SMOKE": smoke, "np": np, **names})


def _call_name(call: ast.Call) -> str:
    f = call.func
    return f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else ""


def _expected(fname: str, smoke: bool, top: str, seed: int) -> dict:
    """{(context, key): value} of the JAX config function ``fname`` (and of
    the module function it returns the call of) at ``seed``.  ``top`` is the
    agent config's class: its keywords, a ``dict(...)`` spread into it and a
    delegating call's keywords all land on context ``"config"``."""
    fn = FUNCS[fname]
    names = {"seed": seed}
    for node in fn.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                names[node.targets[0].id] = _value(node.value, smoke, names)
            except Exception:
                pass
    out, delegate, returned = {}, None, set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call) and _call_name(node.value) in FUNCS:
            delegate = node.value
            out.update(_expected(_call_name(delegate), smoke, top, seed))
        elif isinstance(node, ast.Return):
            returned.add(id(node.value))  # the summary record, not hyperparameters
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or id(node) in returned:
            continue
        ctx = "config" if node is delegate or _call_name(node) in (top, "dict") else _call_name(node)
        if ctx == "make":
            out[("make", "env_id")] = _value(node.args[0], smoke, names)
        if ctx == "policy_eval" and len(node.args) > 2:
            out[("policy_eval", "rep")] = _value(node.args[2], smoke, names)
        for kw in node.keywords:
            if kw.arg in (None, "log", "_name"):
                continue
            v = kw.value
            if kw.arg == "known_pareto_front" and isinstance(v, ast.Call) and _call_name(v) == "pareto_front":
                out[("front_gamma", "")] = _value(v.args[0], smoke, names)
                continue
            try:
                out[(ctx, kw.arg)] = _value(v, smoke, names)
            except Exception:
                continue  # not a literal: config=..., variant or dict(...)
    for loop_var in ("total", "seg_steps"):  # MOSAC's own loop
        if loop_var in names:
            out[("loop", loop_var)] = names[loop_var]
    return out


def _find(obj, cls_name: str):
    """The dataclass of class ``cls_name`` in the config tree ``obj``."""
    if type(obj).__name__ == cls_name:
        return obj
    for v in vars(obj).values() if hasattr(obj, "__dataclass_fields__") else ():
        if hasattr(v, "__dataclass_fields__") and (hit := _find(v, cls_name)) is not None:
            return hit
    return None


def _port_value(sp: parity.Spec, ctx: str, key: str):
    if ctx in ("train", "policy_eval", "loop"):
        return sp.train[key]
    if ctx == "make":
        return sp.env_id if key == "env_id" else sp.env_kwargs[key]
    if ctx == "front_gamma":
        return sp.front_gamma
    if ctx == sp.agent.__name__:
        return sp.agent_kwargs[key]
    obj = sp.config if ctx == "config" else _find(sp.config, ctx)
    assert obj is not None, f"no {ctx} in the port's config"
    if not hasattr(obj, key):
        # dropped from the port: it always runs the JAX default, so the JAX value must be that default
        return getattr(DROPPED[ctx](), key)
    return getattr(obj, key)


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return type(a) is type(b) and a == b if isinstance(a, bool) or isinstance(b, bool) else a == b


def test_config_names_equal_jax():
    assert list(parity.SPECS) == list(CONFIGS)
    assert len(CONFIGS) == 22


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "reference"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_literal_hyperparameters_equal_jax(name, smoke):
    sp = parity.spec(name, 3, smoke)
    want = _expected(CONFIGS[name], smoke, type(sp.config).__name__, 3)
    assert len(want) >= 5 and any(key == "seed" for _, key in want), want
    for (ctx, key), value in want.items():
        if ctx in SUMMARY_CALLS:
            continue
        got = _port_value(sp, ctx, key)
        assert _same(got, value), f"{name} {ctx}.{key}: port {got!r}, JAX {value!r}"


def _summary(out: Path) -> list:
    return [json.loads(line) for line in open(out / "parity_summary.jsonl")]


# the reference metric names each config's curve logs, and the JAX record's summary fields
SMOKE_RUNS = {
    "pql_dst": ({"eval/hypervolume", "eval/eum", "eval/igd", "eval/mul"}, {"front", "tracking", "metrics"}),
    "mpmoql_dst": ({"eval/hypervolume", "eval/eum", "eval/igd", "eval/mul"}, {"ccs", "metrics"}),
    "capql_hopper": ({"eval/hypervolume", "eval/eum", "eval/cardinality"}, {"metrics"}),
}


@pytest.mark.parametrize("name", list(SMOKE_RUNS))
def test_smoke_run_on_cpu(name, tmp_path):
    metric_names, fields = SMOKE_RUNS[name]
    assert parity.main([name, "--seeds=0", "--smoke", "--device", "cpu", "--out", str(tmp_path)]) == 0
    curve = [json.loads(line) for line in open(tmp_path / f"parity_{name}_seed0.jsonl")]
    assert curve and metric_names <= set(curve[-1]), curve[-1]
    (rec,) = _summary(tmp_path)
    assert "exception" not in rec
    assert fields | {"config", "seed", "wall", "device", "global_step"} <= set(rec)
    assert rec["device"] == "cpu" and rec["global_step"] == curve[-1]["global_step"] > 0
    assert metric_names <= set(rec["metrics"]) and all(np.isfinite(v) for v in rec["metrics"].values())


def test_exception_is_recorded_and_runner_goes_on(tmp_path, monkeypatch, capsys):
    """A config that raises gets an ``exception`` record, its traceback on
    stderr, and a non-zero exit after the next config ran; IPRO's own numeric
    ``error`` stays a number beside it."""

    def broken(seed, smoke):
        raise ValueError(f"broken at seed {seed}")

    monkeypatch.setitem(parity.SPECS, "pql_dst", broken)
    rc = parity.main(["pql_dst", "ipro_dst", "--seeds=0", "--smoke", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 1
    bad, ipro = _summary(tmp_path)
    assert bad["config"] == "pql_dst" and bad["exception"] == "ValueError('broken at seed 0')"
    assert "Traceback" in capsys.readouterr().err
    assert ipro["config"] == "ipro_dst" and "exception" not in ipro
    assert isinstance(ipro["error"], float) and np.isfinite(ipro["error"])
    assert {"pf", "coverage", "replay_triggered", "dist_to_known_front"} <= set(ipro)


def test_cuda_by_default(monkeypatch, tmp_path):
    """Without ``--device cpu`` the runner asks for CUDA and raises before running anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.main(["pql_dst", "--smoke", "--out", str(tmp_path)])
    assert not (tmp_path / "parity_summary.jsonl").exists()


def test_default_out_dirs(monkeypatch, tmp_path):
    """Records go to results/torch at the repository root; smoke runs to the temporary directory."""
    assert parity.RESULTS == Path(__file__).resolve().parents[1] / "results" / "torch"
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert parity.main(["mpmoql_dst", "--seeds=1", "--smoke", "--device", "cpu"]) == 0
    assert [r["seed"] for r in _summary(tmp_path / "parity_smoke")] == [1]


def test_runner_imports_neither_jax_nor_scripts():
    tree = ast.parse(Path(parity.__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0}
    banned = ("jax", "jaxlib", "flax", "morl_baselines_tpu", "scripts")
    assert not [m for m in mods if m.split(".")[0] in banned], mods


def test_table_reads_jax_records():
    """``--table`` reads the JAX runner's records unchanged: the final front's
    HV is the summary's, the curve's statistics are ``_hv_trajectory``'s, the
    ESR utility is min(fish, wood // 2) of the discounted return."""
    root = JAX_RUNNER.parents[1] / "results" / "r2"
    rows = {(r["config"], r["seed"]): r for r in parity.table([root])}
    recs = {(r["config"], r["seed"]): r for r in _summary(root)}
    env = rows[("envelope_minecart", 1)]
    assert env["final_hv"] == recs[("envelope_minecart", 1)]["metrics"]["eval/hypervolume"] == env["hv_final"]
    assert env["hv_final3_median"] <= env["hv_max"]
    fish, wood = recs[("eupg_fishwood", 2)]["last_eval"][1]
    assert rows[("eupg_fishwood", 2)]["esr_utility"] == pytest.approx(min(fish, np.floor(wood / 2)))
