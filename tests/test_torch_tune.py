"""The port's GPI-LS minecart tuning sweep
(``morl_baselines_torch/cli/gpils_minecart_tune.py``) against the JAX
package's ``scripts/gpils_minecart_tune.py``.

The JAX script is read with ``ast`` and never imported (it puts a fixed
checkout path on ``sys.path`` when imported).  Its ``VARIANTS``, ``TOTALS``,
default total, base config, env id, reference point, ``train`` keywords and
record keys must be what the port's ``run`` uses: every variant runs through
``run`` with the agent and the env replaced by recorders, and a mutated
literal in a copy of the port is caught.  Variant B must equal the protocol
runner's ``gpils_minecart`` config.  ``buffer_diagnostic`` is the JAX
function compiled from the script's AST, applied to a JAX buffer, beside the
port's on a port buffer holding the same rows.  Then the CLI runs variant F
on the CPU at a small total.
"""

import ast
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_tpu.replay import PrioritizedReplayBuffer as JPrioritizedReplayBuffer
from morl_baselines_tpu.replay import ReplayBuffer as JReplayBuffer
from morl_baselines_tpu.replay import Transition as JTransition
from morl_baselines_torch.agents import GPILSConfig
from morl_baselines_torch.cli import gpils_minecart_tune as tune
from morl_baselines_torch.cli import parity
from morl_baselines_torch.replay import PrioritizedReplayBuffer, ReplayBuffer, Transition

torch.set_num_threads(1)

JAX_TUNE = Path(__file__).resolve().parents[1] / "scripts" / "gpils_minecart_tune.py"
TREE = ast.parse(JAX_TUNE.read_text())
FUNCS = {n.name: n for n in TREE.body if isinstance(n, ast.FunctionDef)}


def _assigned(name: str):
    node = next(n for n in TREE.body if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == name)
    return eval(compile(ast.Expression(node.value), str(JAX_TUNE), "eval"), {"__builtins__": {}, "dict": dict})


def _calls(fn: ast.FunctionDef, name: str) -> list:
    return [
        n for n in ast.walk(fn)
        if isinstance(n, ast.Call) and getattr(n.func, "id", getattr(n.func, "attr", None)) == name
    ]


def _literal(node):
    return eval(compile(ast.Expression(node), str(JAX_TUNE), "eval"), {"__builtins__": {}, "np": np})


def _jax_expected() -> dict:
    """What the JAX ``run`` passes, read from its AST."""
    run = FUNCS["run"]
    (get,) = [c for c in _calls(run, "get") if getattr(c.func.value, "id", None) == "TOTALS"]
    (cfg,) = _calls(run, "GPILSConfig")
    (mk,) = _calls(run, "make")
    (arr,) = _calls(run, "array")
    (train,) = _calls(run, "train")
    (front,) = _calls(run, "pareto_front")
    (rec,) = [c for c in _calls(run, "dict") if any(k.arg == "variant" for k in c.keywords)]
    (diag,) = [c for c in _calls(FUNCS["buffer_diagnostic"], "dict")]
    base = {k.arg: _literal(k.value) for k in cfg.keywords if isinstance(k.value, ast.Constant)}
    assert [k.arg for k in cfg.keywords if k.arg is not None] == ["gamma", "learning_starts", "seed"]
    return dict(
        variants=_assigned("VARIANTS"),
        totals=_assigned("TOTALS"),
        default_total=_literal(get.args[1]),
        base=base,
        env_id=_literal(mk.args[0]),
        ref_point=_literal(arr),
        front_gamma=_literal(front.args[0]),
        train={k.arg: _literal(k.value) for k in train.keywords if isinstance(k.value, ast.Constant)},
        train_keys={k.arg for k in train.keywords},
        record_keys=[k.arg for k in rec.keywords if k.arg] + [k.arg for k in diag.keywords],
    )


JAX = _jax_expected()


class _Stop(Exception):
    pass


def _recorded_run(mod, name: str, seed: int, tmp: Path) -> dict:
    """``mod.run(name, seed)`` on the CPU with ``make`` and ``GPILS`` replaced
    by recorders; stops at ``train`` and returns what ``run`` passed."""
    seen = {}

    class Env:
        def pareto_front(self, gamma):
            seen["front_gamma"] = gamma
            return np.zeros((1, 3))

    class Agent:
        def __init__(self, env, config, log=False, device="cuda"):
            seen["config"] = config

        def train(self, **kw):
            seen["train"] = kw
            raise _Stop

    def make(env_id):
        seen["env_id"] = env_id
        return Env()

    old = mod.make, mod.GPILS
    mod.make, mod.GPILS = make, Agent
    try:
        with pytest.raises(_Stop):
            mod.run(name, seed, device="cpu", out=tmp)
    finally:
        mod.make, mod.GPILS = old
    return seen


def mismatches(mod, tmp: Path) -> list:
    """Every way ``mod``'s variants differ from the JAX script's."""
    bad = []
    if set(mod.VARIANTS) != set(JAX["variants"]):
        bad.append(("variants", sorted(mod.VARIANTS)))
    for name, kw in JAX["variants"].items():
        seed = 3
        seen = _recorded_run(mod, name, seed, tmp)
        want = GPILSConfig(**JAX["base"], seed=seed, **kw)
        if seen["config"] != want:
            bad.append((name, "config", seen["config"]))
        t = seen["train"]
        total = JAX["totals"].get(name, JAX["default_total"])
        if t.get("total_timesteps") != total:
            bad.append((name, "total", t.get("total_timesteps")))
        if not np.array_equal(t.get("ref_point"), JAX["ref_point"]):
            bad.append((name, "ref_point", t.get("ref_point")))
        if set(t) != JAX["train_keys"] or any(t[k] != v for k, v in JAX["train"].items()):
            bad.append((name, "train", t))
        if (seen["env_id"], seen["front_gamma"]) != (JAX["env_id"], JAX["front_gamma"]):
            bad.append((name, "env", seen["env_id"], seen["front_gamma"]))
    return bad


def test_literals_against_the_jax_script(tmp_path):
    assert mismatches(tune, tmp_path) == []
    assert len(JAX["variants"]) == 6 and JAX["totals"] == {"F": 150_000} and JAX["default_total"] == 2_500_000


MUTATIONS = [
    ("epsilon_decay_steps=15_000, target_net_update_freq=100", "epsilon_decay_steps=15_000, target_net_update_freq=101"),
    ("tau=0.005, max_support=32", "tau=0.005, max_support=16"),
    ('TOTALS = {"F": 150_000}', 'TOTALS = {"F": 160_000}'),
    ("DEFAULT_TOTAL = 2_500_000", "DEFAULT_TOTAL = 2_000_000"),
    ("gamma=0.98, learning_starts=2048", "gamma=0.98, learning_starts=1024"),
    ('ENV_ID = "minecart-v0"', 'ENV_ID = "minecart-deterministic-v0"'),
    ("REF_POINT = (0.0, 0.0, -200.0)", "REF_POINT = (0.0, 0.0, -100.0)"),
    ("FRONT_GAMMA = 0.98", "FRONT_GAMMA = 0.99"),
    ("num_eval_weights_for_front=32, eval_max_steps=400", "num_eval_weights_for_front=16, eval_max_steps=400"),
    ("TRAIN = dict(timesteps_per_iter=10_000", "TRAIN = dict(timesteps_per_iter=5_000"),
]


@pytest.mark.parametrize("old,new", MUTATIONS, ids=[f"m{i}" for i in range(len(MUTATIONS))])
def test_mutated_literal_is_caught(tmp_path, old, new):
    src = Path(tune.__file__).read_text()
    assert src.count(old) == 1, old
    path = tmp_path / "gpils_minecart_tune_mutated.py"
    path.write_text(src.replace(old, new))
    spec = importlib.util.spec_from_file_location("morl_baselines_torch.cli.gpils_minecart_tune_mutated", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mismatches(mod, tmp_path), f"{old!r} -> {new!r} not caught"


def test_variant_b_is_the_parity_config(tmp_path):
    sp = parity.spec("gpils_minecart", 0, smoke=False)
    seen = _recorded_run(tune, "B", 0, tmp_path)
    assert seen["config"] == sp.config == tune.config("B", 0)
    t, want = seen["train"], dict(sp.train)
    np.testing.assert_array_equal(t.pop("ref_point"), want.pop("ref_point"))
    t.pop("known_pareto_front")
    assert t == want
    assert (seen["env_id"], seen["front_gamma"]) == (sp.env_id, sp.front_gamma)


def _rows(rng, n):
    reward = rng.normal(size=(n, 3)).astype(np.float32)
    reward[:, :2] = np.where(rng.uniform(size=(n, 2)) < 0.8, 0.0, np.abs(reward[:, :2]))  # ~36% sales
    return dict(
        obs=rng.normal(size=(n, 7)).astype(np.float32),
        action=rng.integers(0, 6, size=n),
        reward=reward,
        next_obs=rng.normal(size=(n, 7)).astype(np.float32),
        terminated=(rng.uniform(size=n) < 0.05).astype(np.float32),
    )


def _jax_diagnostic():
    """The JAX script's ``buffer_diagnostic``, compiled from its AST."""
    ns = {"np": np}
    exec(compile(ast.Module([FUNCS["buffer_diagnostic"]], []), str(JAX_TUNE), "exec"), ns)
    return ns["buffer_diagnostic"]


@pytest.mark.parametrize("per", [False, True])
@pytest.mark.parametrize("batches", [(40,), (30, 50)], ids=["partial", "wrapped"])
def test_buffer_diagnostic(per, batches):
    rng = np.random.default_rng(len(batches) + 2 * per)
    jcls, cls = (JPrioritizedReplayBuffer, PrioritizedReplayBuffer) if per else (JReplayBuffer, ReplayBuffer)
    jbuf, buf = jcls.create(64, obs_dim=7, reward_dim=3), cls.create(64, obs_dim=7, reward_dim=3, device="cpu")
    for n in batches:
        b = _rows(rng, n)
        jbuf = jbuf.add_batch(JTransition(**{k: jnp.asarray(v, jnp.int32 if k == "action" else None) for k, v in b.items()}))
        buf = buf.add_batch(Transition(**{k: torch.as_tensor(v) for k, v in b.items()}))
    want = _jax_diagnostic()(SimpleNamespace(buffer=jbuf), None)
    got = tune.buffer_diagnostic(SimpleNamespace(buffer=buf))
    assert got == want
    assert got["buffer_size"] == min(sum(batches), 64) and 0 < got["sale_rows"] < got["buffer_size"]


def test_cli_runs_variant_f(tmp_path):
    """Variant F on the CPU: 2 outer iterations of 1088 steps (a few hundred
    gradient updates after ``learning_starts``), its record and its curve."""
    argv = ["F", "--device", "cpu", "--total", "2176", "--timesteps-per-iter", "1088", "--out", str(tmp_path)]
    assert tune.main(argv) == 0
    (rec,) = map(json.loads, (tmp_path / "gpils_minecart_tune.jsonl").read_text().splitlines())
    assert list(rec) == JAX["record_keys"] + ["device"]
    assert (rec["variant"], rec["seed"], rec["total"], rec["device"]) == ("F", 0, 2176, "cpu")
    assert rec["buffer_size"] == 2176 and 0 <= rec["sale_rows"] <= rec["buffer_size"]
    assert {"eval/hypervolume", "eval/eum", "eval/igd", "eval/mul"} <= set(rec["metrics"])
    assert rec["ccs"] and all(len(v) == 3 and np.isfinite(v).all() for v in rec["ccs"])
    curve = [json.loads(line) for line in (tmp_path / "gpils_minecart_tune_F_seed0.jsonl").read_text().splitlines()]
    assert [r["global_step"] for r in curve] == [1088, 2176]
    assert curve[-1]["eval/hypervolume"] == rec["metrics"]["eval/hypervolume"]


def test_cli_records_a_raise_and_goes_on(tmp_path, monkeypatch):
    """A variant that raises is recorded under ``exception``, the next runs,
    and the exit code is non-zero."""
    monkeypatch.setitem(tune.VARIANTS, "X", dict(no_such_option=1))
    monkeypatch.setitem(tune.VARIANTS, "Y", dict(num_envs=4, no_such_option=2))
    assert tune.main(["X", "Y", "--device", "cpu", "--out", str(tmp_path)]) == 1
    recs = [json.loads(line) for line in (tmp_path / "gpils_minecart_tune.jsonl").read_text().splitlines()]
    assert [r["variant"] for r in recs] == ["X", "Y"]
    assert all("no_such_option" in r["exception"] for r in recs)


def test_cuda_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune.main(["F", "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        tune.main(["Z", "--device", "cpu", "--out", str(tmp_path)])
