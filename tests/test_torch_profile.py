"""The port's four bench breakdowns (``morl_baselines_torch/cli/profile_gpils.py``,
``profile_population.py``, ``bench_gpils_ab.py``, ``probe_planar.py``) against
the JAX package's ``scripts/`` of the same names.

The JAX scripts are read with ``ast`` and never imported.  Each record they
print is keyed by its first field (``metric``, ``note``, ``workload``,
``probe`` or ``bf16_act``); every line a probe of the port prints at tiny
sizes on the CPU must carry exactly the keys of the JAX record of that name,
and every JAX record must appear.  The agents' nets are narrowed to (32, 32)
here (their configs patched in the probe modules) so that a probe runs in
seconds on one thread; the sizes the probes choose stay theirs.
"""

import ast
import functools
import json
from pathlib import Path

import pytest
import torch

from morl_baselines_torch.agents import EnvelopeConfig, GPILSConfig, MOPPOConfig, MOSACConfig
from morl_baselines_torch.cli import bench_gpils_ab, probe_planar, profile_gpils, profile_population
from morl_baselines_torch.envs import make

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
DISCRIMINATORS = ("metric", "note", "workload", "probe", "bf16_act")
# the port's probe names where it times another function in the same place
PORT_PROBES = {"substep_only": "qdd_only", "planar_solve_9x9": "unrolled_gauss_9x9"}
SOLVE_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 on SPD 9x9 systems of condition number < 3


def _records(script: str) -> dict:
    """{(discriminator, its value or None): frozenset of keys} of every record
    the JAX script prints: ``emit(**kw)`` calls and dict literals."""
    out = {}
    for node in ast.walk(ast.parse((SCRIPTS / script).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "emit":
            fields = {kw.arg: kw.value for kw in node.keywords}
        elif isinstance(node, ast.Dict) and all(isinstance(k, ast.Constant) for k in node.keys):
            fields = {k.value: v for k, v in zip(node.keys, node.values)}
        else:
            continue
        disc = next((k for k in DISCRIMINATORS if k in fields), None)
        if disc is None:
            continue
        value = fields[disc].value if isinstance(fields[disc], ast.Constant) and disc != "bf16_act" else None
        out[(disc, value)] = frozenset(fields)
    return out


def _check_keys(script: str, out: str) -> list:
    want = _records(script)
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    seen = set()
    for rec in lines:
        disc = next(k for k in DISCRIMINATORS if k in rec)
        value = None if disc == "bf16_act" else PORT_PROBES.get(rec[disc], rec[disc])
        assert (disc, value) in want, f"{script}: no JAX record {disc}={value}"
        assert set(rec) == want[(disc, value)], f"{script} {disc}={value}: {sorted(rec)} != {sorted(want[(disc, value)])}"
        seen.add((disc, value))
    assert seen == set(want), f"{script}: JAX records not printed: {set(want) - seen}"
    return lines


def _narrow(monkeypatch, module, *configs):
    for cfg in configs:
        monkeypatch.setattr(module, cfg.__name__, functools.partial(cfg, hidden=(32, 32)))


def test_profile_gpils_keys(monkeypatch, capsys):
    _narrow(monkeypatch, profile_gpils, GPILSConfig, EnvelopeConfig)
    assert profile_gpils.main(["--small", "--device", "cpu"]) == 0
    lines = _check_keys("profile_gpils.py", capsys.readouterr().out)
    by = {r.get("metric"): r for r in lines}
    assert by["gpils_gpi_act_s_per_iter"]["rows"] == 32 * 16 and by["envelope_act_s_per_iter"]["rows"] == 64
    assert by["gpils_update_chain_s_per_iter"]["updates"] == 10
    assert all(r["value"] > 0 for r in lines if "value" in r)


def test_profile_population_keys(monkeypatch, capsys):
    _narrow(monkeypatch, profile_population, MOSACConfig)
    monkeypatch.setattr(profile_population, "MOPPOConfig", functools.partial(MOPPOConfig, update_epochs=2, num_minibatches=4))
    assert profile_population.main(["--small", "--device", "cpu"]) == 0
    pgmorl, morld = _check_keys("profile_population.py", capsys.readouterr().out)
    assert (pgmorl["num_envs"], pgmorl["rollout_steps"], pgmorl["sequential_updates"]) == (32, 8, 8)
    assert pgmorl["rollout_s"] == pytest.approx(pgmorl["iteration_s"] - pgmorl["update_chain_s"], abs=2e-4)
    assert (morld["num_envs"], morld["seg_iters"], morld["pop"]) == (4, 2, 6)


def _jax_sweep() -> list:
    """[(function, env counts, keywords)] of the JAX ``sweep_envs`` loops."""
    fn = next(n for n in ast.parse((SCRIPTS / "profile_population.py").read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "sweep_envs")
    out = []
    for loop in fn.body:
        call = loop.body[0].value
        kws = {k.arg: k.value.value for k in call.keywords if isinstance(k.value, ast.Constant)}
        out.append((call.func.id, ast.literal_eval(loop.iter), kws))
    return out


def test_sweep_env_counts_equal_jax(monkeypatch):
    calls = []
    monkeypatch.setattr(profile_population, "profile_pgmorl", lambda device, **kw: calls.append(("profile_pgmorl", kw)))
    monkeypatch.setattr(profile_population, "profile_morld", lambda device, **kw: calls.append(("profile_morld", kw)))
    assert profile_population.main(["--sweep", "--device", "cpu"]) == 0
    want = []
    for name, counts, kws in _jax_sweep():
        want += [(name, {"num_envs": n, **kws}) for n in counts]
    assert calls == want
    assert [kw["num_envs"] for n, kw in calls if n == "profile_pgmorl"] == [64, 256, 1024, 4096]


def test_trace_writes_a_trace(monkeypatch, tmp_path):
    ran = []
    monkeypatch.setattr(profile_population, "profile_pgmorl", lambda device, **kw: ran.append(torch.ones(4).sum()))
    monkeypatch.setattr(profile_population, "profile_morld", lambda device, **kw: ran.append(kw))
    assert profile_population.main([f"--trace={tmp_path}", "--device", "cpu"]) == 0
    assert len(ran) == 2 and (tmp_path / "trace.json").stat().st_size > 0


def test_bench_gpils_ab_keys(monkeypatch, capsys):
    _narrow(monkeypatch, bench_gpils_ab, GPILSConfig)
    assert bench_gpils_ab.main(["--small", "--device", "cpu"]) == 0
    lines = _check_keys("bench_gpils_ab.py", capsys.readouterr().out)
    assert [r["bf16_act"] for r in lines] == [False, True] and all(r["sps"] > 0 for r in lines)


def test_probe_planar_keys(capsys):
    assert probe_planar.main(["64", "--device", "cpu"]) == 0
    lines = _check_keys("probe_planar.py", capsys.readouterr().out)
    assert [r["probe"] for r in lines] == [
        "full_step", "substep_only", "linalg_solve_9x9", "cholesky_solve_9x9", "unrolled_gauss_9x9", "planar_solve_9x9",
    ]
    assert all(r["batch"] == 64 for r in lines)
    assert [r["matches_solve"] for r in lines if "matches_solve" in r] == [True, True]


def test_planar_solve_agrees_with_linalg_solve():
    """The env's own Gauss-Jordan (``PlanarDynamics.solve``), the probe's and
    the Cholesky solve against ``torch.linalg.solve`` on the probe's SPD batch."""
    env = make("mo-halfcheetah-jx-v5", device="cpu")
    M, rhs = probe_planar.spd_batch(2048, env.nq, torch.device("cpu"))
    assert M.shape == (2048, 9, 9) and torch.linalg.cond(M).max() < 3
    want = torch.linalg.solve(M, rhs)
    torch.testing.assert_close(env.dyn.solve(torch.cat([M, rhs[..., None]], dim=-1)), want, **SOLVE_TOL)
    torch.testing.assert_close(probe_planar.gauss(M, rhs), want, **SOLVE_TOL)
    torch.testing.assert_close(probe_planar.cholesky_solve(M, rhs), want, **SOLVE_TOL)


@pytest.mark.parametrize("module", [profile_gpils, profile_population, bench_gpils_ab, probe_planar],
                         ids=["profile_gpils", "profile_population", "bench_gpils_ab", "probe_planar"])
def test_cuda_by_default_without_fallback(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
