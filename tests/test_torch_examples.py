"""The port's examples run end to end on the CPU at tiny budgets.

Mirror of tests/test_examples.py: each ``morl_baselines_torch.examples``
module's ``main(["--device", "cpu"])`` runs with every agent's config and
train budget shrunk by that file's table (recursive dataclass replace and
train kwarg clamps), so construction, the train loop, evaluation, logging
and checkpointing are exercised.  The four examples on the host-stepped
MuJoCo envs are in tests/test_torch_examples_mujoco.py.
"""

import importlib
import inspect
import pathlib

import pytest
import torch

from test_examples import _TRAIN_CAPS, _TRAIN_SETS, _shrink_cfg

torch.set_num_threads(1)

EXAMPLES = sorted(p.stem for p in (pathlib.Path(__file__).parent.parent / "morl_baselines_torch" / "examples").glob("*.py"))
EXAMPLES.remove("__init__")
MUJOCO = ["gpi_ls_hopper", "morld_cheetah", "morld_hopper", "pgmorl_halfcheetah"]


def shrink_agents(monkeypatch):
    """Patch every agent class of the port to shrink its config and train budget."""
    import morl_baselines_torch.agents as agents_mod

    classes = {id(c): c for c in map(lambda n: getattr(agents_mod, n), dir(agents_mod)) if isinstance(c, type)}
    for cls in classes.values():
        if not hasattr(cls, "train"):
            continue

        def make_wrapped(c):
            orig_init, orig_train = c.__init__, c.train
            takes_max_steps = "eval_max_steps" in inspect.signature(orig_train).parameters

            def init(self, *a, **kw):
                a = tuple(_shrink_cfg(x) for x in a)
                kw = {k: _shrink_cfg(v) for k, v in kw.items()}
                return orig_init(self, *a, **kw)

            def train(self, *a, **kw):
                if a:  # total_timesteps passed positionally
                    a = (min(a[0], _TRAIN_CAPS["total_timesteps"]),) + a[1:]
                for k, cap in _TRAIN_CAPS.items():
                    if k in kw and isinstance(kw[k], int):
                        kw[k] = min(kw[k], cap)
                for k, v in _TRAIN_SETS.items():
                    if k in kw:
                        kw[k] = v
                if takes_max_steps:
                    kw.setdefault("eval_max_steps", 40)
                return orig_train(self, *a, **kw)

            return init, train

        init, train = make_wrapped(cls)
        monkeypatch.setattr(cls, "__init__", init)
        monkeypatch.setattr(cls, "train", train)


def run_example(stem, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # morld_checkpoint_restore writes under the temporary directory
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    shrink_agents(monkeypatch)
    module = importlib.import_module(f"morl_baselines_torch.examples.{stem}")
    agent = module.main(["--device", "cpu"])
    assert agent.device.type == "cpu"
    return agent


@pytest.mark.parametrize("stem", [s for s in EXAMPLES if s not in MUJOCO])
def test_example_runs(stem, monkeypatch, tmp_path):
    run_example(stem, monkeypatch, tmp_path)
    if stem == "morld_checkpoint_restore":
        assert sorted(p.name for p in (tmp_path / "morld_ckpt").iterdir()) == [f"member_{i}" for i in range(2)]


def test_every_example_is_ported():
    """One module per ``examples/*.py`` of the JAX package, with the same stem."""
    jax_examples = sorted(p.stem for p in (pathlib.Path(__file__).parent.parent / "examples").glob("*.py"))
    assert EXAMPLES == jax_examples and len(EXAMPLES) == 20
    assert set(MUJOCO) <= set(EXAMPLES)
