"""The port's four examples on the host-stepped MuJoCo envs run end to end on
the CPU at tiny budgets (the shrink table of tests/test_examples.py, through
tests/test_torch_examples.py's harness); gated on gymnasium and mujoco."""

import pytest
import torch

pytest.importorskip("gymnasium")
pytest.importorskip("mujoco")

from test_torch_examples import MUJOCO, run_example  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("stem", MUJOCO)
def test_example_runs(stem, monkeypatch, tmp_path):
    agent = run_example(stem, monkeypatch, tmp_path)
    assert agent.env.name in ("mo-hopper-v5", "mo-halfcheetah-v5")
