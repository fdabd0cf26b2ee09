"""The port's render helpers against the JAX package's.

``render_frame`` on deep-sea-treasure and on the lunar lander must equal the
JAX package's frames bitwise at equal states; ``rollout_frames``,
``make_gif`` and ``visualize_eval`` mirror tests/test_extras.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from morl_baselines_tpu.envs import make as jmake
from morl_baselines_tpu.envs.dst import DSTState as JDSTState
from morl_baselines_tpu.envs.lunar_lander import LLState as JLLState
from morl_baselines_torch.envs import make
from morl_baselines_torch.envs.dst import DSTState
from morl_baselines_torch.models.dynamics import EnsembleConfig, ProbabilisticEnsemble, visualize_eval
from morl_baselines_torch.utils import make_gif, rollout_frames

torch.set_num_threads(1)


def test_render_and_gif(tmp_path):
    """Mirror of tests/test_extras.py::test_render_and_gif."""
    env = make("deep-sea-treasure-v0")
    frames = rollout_frames(env, lambda obs, g: torch.tensor([3]), torch.Generator().manual_seed(0), max_steps=4)
    assert len(frames) == 5  # the reset frame and 4 steps right along the surface
    assert frames[0].ndim == 3 and frames[0].shape[2] == 3 and frames[0].dtype == np.uint8
    p = make_gif(frames, tmp_path / "dst")
    assert p.exists() and p.suffix == ".gif"


def test_visualize_eval(tmp_path):
    """Mirror of the ``visualize_eval`` half of
    tests/test_extras.py::test_visualize_eval_and_reset_wandb_env."""
    import matplotlib.pyplot as plt

    env = make("deep-sea-treasure-v0")
    model = ProbabilisticEnsemble(
        input_dim=env.obs_dim + 1,
        output_dim=env.obs_dim + env.reward_dim,
        cfg=EnsembleConfig(num_members=3, num_elites=2, hidden=(16, 16)),
        device="cpu",
    )
    mstate = model.init_state(0)
    act = lambda obs, w, g: torch.randint(0, env.num_actions, (1,), generator=g)  # noqa: E731
    fig = visualize_eval(act, env, model, mstate, horizon=5, gen=torch.Generator().manual_seed(1),
                         save_path=str(tmp_path / "viz.png"))
    assert (tmp_path / "viz.png").exists()
    assert len(fig.axes) == 4 and len(fig.axes[0].lines) == 2  # real and model per panel
    plt.close(fig)
    # one-step (non-compound) mode also runs
    plt.close(visualize_eval(act, env, model, mstate, horizon=3, compound=False))


def test_dst_render_frame_equal_jax():
    """Every cell of the grid, the submarine drawn over sea, treasure and the surface."""
    env, jenv = make("deep-sea-treasure-v0"), jmake("deep-sea-treasure-v0")
    for row in range(11):
        for col in (0, 3, 9):
            got = env.render_frame(DSTState(torch.tensor([row], dtype=torch.int32), torch.tensor([col], dtype=torch.int32),
                                            torch.zeros(1, dtype=torch.int32)))
            want = jenv.render_frame(JDSTState(jnp.int32(row), jnp.int32(col), jnp.int32(0)))
            assert got.dtype == want.dtype and np.array_equal(got, want), (row, col)


def test_lander_render_frame_equal_jax():
    """Landers from 16 random resets over 60 random steps each (tilted,
    falling, some partly off the frame) render as the JAX package's."""
    for env_id in ("mo-lunar-lander-v3", "mo-lunar-lander-continuous-v3"):
        env, jenv = make(env_id), jmake(env_id)
        gen = torch.Generator().manual_seed(0)
        state, _ = env.reset(16, gen)
        for step in range(60):
            out = env.step(state, env.action_space.sample(gen, 16), env.sample_noise(16, gen))
            state = out.state
            if step % 20 != 19:
                continue
            for i in range(16):
                one = type(state)(*(x[i : i + 1] for x in state))
                got = env.render_frame(one)
                want = jenv.render_frame(JLLState(*(jnp.asarray(x[i].numpy()) for x in state)))
                assert got.shape == (267, 400, 3) and np.array_equal(got, want), (env_id, step, i)
