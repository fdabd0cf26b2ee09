"""The algorithm module's contract (``harness.py``) beyond its defaults, and
the numbers and faults that reach an actor-critic learner.

- The plumbing: ``mosac_stub.py`` (beside this file) drives the program's
  MOSAC through ``harness.run_cell`` under the ``"polyak"`` target rule, with
  members x envs env steps an iteration, three optimizers and no PER; its
  reference is a second build of the program, so every number reads 0, and a
  program-side target that does not move reads not correct.
- ``target_change_gap`` on hand-made tensors.
- Each fault reaches what it names, on the CPU.

    python -m pytest benchmark/tests/test_bench_contract.py -q
"""

import contextlib
import json
import shutil
import sys

import mosac_stub
import pytest
import torch
from conftest import ROOT

from benchmark import check, faults, harness

CPU = torch.device("cpu")
SEED = 2**33 + 29  # more than 32 bits, as a run's seed may be
MEMBERS, ENVS = 2, 4
CONFIG = {"algorithm": "mosac_stub", "env_id": "mo-mountaincarcontinuous-v0", "weight": [0.5, 0.5], "members": MEMBERS,
          "hidden": [16, 16], "learning_rate": 3e-4, "q_learning_rate": 1e-3, "gamma": 0.99, "tau": 0.005,
          "policy_freq": 2, "alpha": 0.2, "autotune": True}
# the second iteration learns first: MOSAC's actor and temperature step on even iterations, so all three optimizers
# hold a moment after the first compared iteration
TRAFFIC = {"num_envs": ENVS, "batch_size": 16, "buffer_size": 256, "per": False, "learning_starts": 8}
LIMITS = {"loss_gap": 1e-6, "moment_gap": 1e-6, "change_gap": 1e-6, "first_change_gap": 1e-6, "target_change_gap": 0.01}


@pytest.fixture(scope="module")
def stub_root(tmp_path_factory):
    """A copy of the benchmark with the cells ``mosac-stub.polyak`` and
    ``mosac-stub.frozen`` (a program whose target does not move)."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "stub.json").write_text(json.dumps(TRAFFIC))
    for name, cfg in (("polyak", CONFIG), ("frozen", dict(CONFIG, frozen_target=True))):
        conf = f"mosac-stub-{name}"
        (root / "benchmark" / "configs" / f"{conf}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": conf, "source": "test", "file": f"benchmark/configs/{conf}.json", "reduced": [], "why": "test"})
        spec["workloads"].append({"name": f"mosac-stub.{name}", "config": conf, "traffic": "stub", "chips": 1, "why": "test"})
        (root / "benchmark" / "limits" / f"mosac-stub.{name}.json").write_text(json.dumps(LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(autouse=True)
def registered(monkeypatch):
    monkeypatch.setitem(sys.modules, "benchmark.algos.mosac_stub", mosac_stub)


def run(root, cell, monkeypatch):
    """``run_cell``'s result, and the window its readers read."""
    windows, real = [], harness.reader

    def reader(where, name):
        read = real(where, name)
        return lambda win: windows.append(win) or read(win)

    monkeypatch.setattr(harness, "reader", reader)
    result, lines = harness.run_cell(root, cell, SEED, 0.3, False, CPU, harness.process_start())
    return result, lines, windows[0]


def test_the_polyak_rule_end_to_end(stub_root, monkeypatch):
    result, lines, win = run(stub_root, "mosac-stub.polyak", monkeypatch)
    assert result["correct"] is True and result["failed"] == 0, result["check"]
    assert list(result["check"]) == list(LIMITS)
    assert result["check"]["target_change_gap"]["value"] == 0.0
    assert all(v["value"] == 0.0 for v in result["check"].values())
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
    # attempted counts iterations; each steps members x envs transitions
    assert win.num_envs == MEMBERS * ENVS and result["attempted"] == win.iters > 0
    assert result["metrics"]["env_steps_per_s"]["value"] == result["attempted"] * MEMBERS * ENVS / win.wall_s
    assert [line.split()[1] for line in lines if line.startswith("[check] ")] == list(LIMITS)


def test_a_program_target_that_does_not_move_is_not_correct(stub_root, monkeypatch):
    result, _, _ = run(stub_root, "mosac-stub.frozen", monkeypatch)
    assert result["correct"] is False
    assert result["check"]["target_change_gap"]["value"] >= 0.99


def test_the_moment_spans_the_three_optimizers(stub_root):
    cell = harness.load_cell(stub_root, "mosac-stub.polyak")
    _, _, readings, probe = harness.program_setup(cell, SEED, CPU)
    assert probe is None
    assert set(readings.moment) == set(mosac_stub.shapes(CONFIG))
    for group in ("actor.", "critic.", "log_alpha"):
        assert any(v > 0 for k, v in readings.moment.items() if k.startswith(group)), group
    assert set(readings.target_change) == {k for k in readings.moment if k.startswith("critic.")}
    assert readings.priorities is None and readings.drawn == []


def test_a_learner_without_a_target_reads_neither_copy_nor_change(stub_root):
    cell = harness.load_cell(stub_root, "mosac-stub.polyak")
    cell.config = dict(cell.config, target_rule="none")
    _, _, readings, probe = harness.program_setup(cell, SEED, CPU)
    assert probe is None and readings.target_change == {}
    gaps = check.compare(readings, harness.reference_readings(cell, SEED, CPU))
    assert "target_change_gap" not in gaps and gaps["loss_gap"] == 0.0


def test_target_change_numbers():
    before = {"a": torch.zeros(3), "b": torch.zeros(2), "c": torch.zeros(4)}
    after = {"a": torch.ones(3), "b": torch.full((2,), 2.0), "c": torch.full((4,), 0.5)}
    moved = check.change_norms(before, after)
    assert check.target_change_gap(moved, moved) == 0.0
    still = check.change_norms(before, before)
    assert check.target_change_gap(still, moved) == 1.0
    # the floor is the median target leaf's: a leaf far under it reads its gap over the median
    small = dict(moved, c=0.0)
    assert check.target_change_gap(small, moved) == pytest.approx(1.0 / moved["a"])
    prog, ref = check.Readings(), check.Readings()
    for side in (prog, ref):
        side.losses, side.moment, side.first_change, side.change = [1.0], {"a": 1.0}, {"a": 1.0}, {"a": 1.0}
    assert "target_change_gap" not in check.compare(prog, ref)  # the copy rule reads no target change
    prog.target_change, ref.target_change = still, moved
    assert check.compare(prog, ref)["target_change_gap"] == 1.0
    with pytest.raises(ValueError):
        check.target_change_gap({"a": 1.0}, moved)


def _adam(seed=0, stepped=True):
    g = torch.Generator().manual_seed(seed)
    params = [torch.randn(5, generator=g).requires_grad_(True), torch.randn(3, 2, generator=g).requires_grad_(True)]
    opt = torch.optim.Adam(params, lr=0.1)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g)
    if stepped:
        opt.step()
        for p in params:
            p.grad = torch.randn(p.shape, generator=g)
    return params, opt


def _state(opt):
    return [{k: v.clone() for k, v in st.items()} for st in opt.state.values()]


@pytest.mark.parametrize("stepped", [False, True])
def test_frozen_leaves_the_learner_s_step_undone(stepped):
    from morl_baselines_torch.ops import adam_step

    params, opt = _adam(stepped=stepped)
    kept, state = [p.detach().clone() for p in params], _state(opt)
    with faults.planted("frozen"):
        adam_step.clip_adam_step_(opt, 1.0)
        adam_step.clip_adam_step_cuda(opt, 1.0)  # the card's entry, patched as well
        opt.step()
    assert all(torch.equal(p, k) for p, k in zip(params, kept))
    after = _state(opt)
    assert len(after) == len(state) and all(a.keys() == s.keys() and all(torch.equal(a[k], s[k]) for k in a)
                                            for a, s in zip(after, state))
    adam_step.clip_adam_step_(opt, 1.0)  # restored on exit
    assert not any(torch.equal(p, k) for p, k in zip(params, kept))


def test_stuck_advances_the_state_and_keeps_the_parameters():
    from morl_baselines_torch.ops import adam_step

    params, opt = _adam()
    kept, state = [p.detach().clone() for p in params], _state(opt)
    with faults.planted("stuck"):
        adam_step.clip_adam_step_(opt, 1.0)
    assert all(torch.equal(p, k) for p, k in zip(params, kept))
    assert all(not torch.equal(a["exp_avg"], s["exp_avg"]) for a, s in zip(_state(opt), state))


def test_half_duplicates_a_member_buffer_s_rows():
    from morl_baselines_torch.replay.buffer import MemberReplayBuffer, Transition

    buf = MemberReplayBuffer.create(2, 64, obs_dim=3, reward_dim=2, device=CPU)
    rows = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    buf.add_batch(Transition(rows[..., None].expand(2, 64, 3), torch.zeros(2, 64, dtype=torch.int64),
                             rows[..., None].expand(2, 64, 2), rows[..., None].expand(2, 64, 3), torch.zeros(2, 64)))
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    sound = buf.sample(gen, 10)
    gen.set_state(state)
    with faults.planted("half"):
        half = buf.sample(gen, 10)
    for x, y in zip(half, sound):
        assert torch.equal(x[:, :5], y[:, :5]) and torch.equal(x[:, 5:], y[:, :5])
    assert not torch.equal(sound.obs[:, 5:], sound.obs[:, :5])


@pytest.mark.parametrize("env_id", ["mo-lunar-lander-continuous-v3", "mo-mountaincarcontinuous-v0"])
def test_action_alters_mosac_s_explore_actions(env_id):
    """Rolled by one along the action dimension; negated where there is one."""
    from morl_baselines_torch.agents.mosac import MOSAC, MOSACConfig
    from morl_baselines_torch.envs import make

    env = make(env_id)
    agent = MOSAC(env, [1.0 / env.reward_dim] * env.reward_dim, MOSACConfig(num_envs=3, learning_starts=0, hidden=(8,)), device=CPU)
    state = agent.init_state(5)
    kept = state.gen.get_state()
    sound = agent._explore(state)
    state.gen.set_state(kept)
    with faults.planted("action"):
        altered = agent._explore(state)
    want = torch.roll(sound, 1, dims=-1) if env.action_dim > 1 else -sound
    assert altered.shape == (1, 3, env.action_dim) and torch.equal(altered, want) and not torch.equal(altered, sound)


def test_nocopy_leaves_a_mosac_target_unchanged():
    from morl_baselines_torch.agents.mosac import MOSAC, MOSACConfig
    from morl_baselines_torch.envs import make

    agent = MOSAC(make("mo-mountaincarcontinuous-v0"), [0.5, 0.5],
                  MOSACConfig(num_envs=4, batch_size=8, buffer_size=64, learning_starts=8, hidden=(8,)), device=CPU)
    moved = {}
    for planted in (False, True):
        state, buffer = agent.init_state(7), agent.make_buffer(1)
        start = [p.detach().clone() for p in state.critic.target_net.parameters()]
        with faults.planted("nocopy") if planted else contextlib.nullcontext():
            agent.train_segment(state, buffer, 4)
        moved[planted] = [not torch.equal(p, s) for p, s in zip(state.critic.target_net.parameters(), start)]
    assert all(moved[False]) and not any(moved[True])
