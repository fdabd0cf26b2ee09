"""The sharding layer's checks at a small size, run by every rank of a gloo
group on the CPU (``tests/test_torch_parallel.py`` starts them through
``launch``; the JAX package's ``tests/test_parallel.py`` holds the same
cases on its 8-device virtual CPU mesh).

``run_cases(rank, world, out_dir)`` runs the seven cases in order and writes
what each found to ``<out_dir>/rank<r>.pt``: mesh shapes; a sharded Envelope
segment; MO-Q-Learning, GPI-LS and continuous GPI-LS sharded beside the
one-process run of the same seed; MORL/D with its members sharded over
``pop``; the envs with step noise, bare and under ``MOMaxAndSkipObservation``,
stepped and evaluated sharded beside the one-process run.  A case that finds
unsynced replicas raises, which fails the run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import assert_replicas_synced, local, make_mesh, shard_agent_state

DEV = "cpu"
GPI_BATCHED = {"env_state", "obs", "task_w", "stats"}


def _mesh_case(world: int) -> dict:
    out = {}
    for names, shape in ((("data",), None), (("pop", "data"), (1, world)), (("pop", "data"), (world, 1))):
        mesh = make_mesh(world, names, shape, device=DEV)
        out[(names, shape)] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    errors = []
    for kwargs in (dict(n_devices=world + 1), dict(axis_names=("pop", "data"))):
        try:
            make_mesh(device=DEV, **kwargs)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def _envelope_case(world: int) -> dict:
    from ..agents import Envelope, EnvelopeConfig
    from ..envs import make

    cfg = EnvelopeConfig(num_envs=16, buffer_size=256, batch_size=16, hidden=(32, 32), learning_starts=8,
                         target_net_update_freq=4, num_sample_w=2)
    agent = Envelope(make("deep-sea-treasure-v0"), cfg, device=DEV)
    state = shard_agent_state(agent.init_state(0), make_mesh(world, device=DEV),
                              batched_fields={"env_state", "obs", "weights", "stats"})
    local_rows = state.obs.shape[0]
    state = agent.train_segment(state, 4)
    assert_replicas_synced(state.ts.net)
    assert_replicas_synced(state.ts.target_net)
    return dict(local_rows=local_rows, global_step=state.global_step, buffer_size=state.buffer.size,
                finite=all(bool(torch.isfinite(p).all()) for p in state.ts.net.parameters()))


def _moql_case(world: int) -> dict:
    from ..agents import MOQLearning, MOQLearningConfig
    from ..envs import make

    def run(sharded: bool) -> np.ndarray:
        agent = MOQLearning(make("deep-sea-treasure-v0"), np.array([0.5, 0.5]), MOQLearningConfig(num_envs=8),
                            device=DEV)
        s = agent.init_state(0)
        if sharded:
            s = shard_agent_state(s, make_mesh(world, device=DEV), batched_fields={"env_state", "obs", "stats"})
        s = agent.train_segment(s, 20)
        if sharded:
            assert_replicas_synced([s.q_table])
        return s.q_table.numpy()

    return dict(single=run(False), sharded=run(True))


def _params(module) -> list:
    return [p.detach().numpy().copy() for p in module.parameters()]


def _gpils_case(world: int) -> dict:
    from ..agents import GPILS, GPILSConfig
    from ..envs import make

    support = [np.array([1.0, 0.0]), np.array([0.0, 1.0]), np.array([0.5, 0.5])]
    cfg = GPILSConfig(num_envs=8, buffer_size=512, batch_size=16, hidden=(32, 32), learning_starts=16,
                      gradient_updates=2, max_support=4, target_net_update_freq=4)

    def run(sharded: bool) -> list:
        agent = GPILS(make("deep-sea-treasure-v0"), cfg, device=DEV)
        s = agent.set_weight_support(agent.init_state(0), support)
        if sharded:
            s = shard_agent_state(s, make_mesh(world, device=DEV), batched_fields=GPI_BATCHED)
        s = agent.train_segment(s, 12, True)
        if sharded:
            assert_replicas_synced(s.ts.net)
        return _params(s.ts.net)

    return dict(single=run(False), sharded=run(True))


def _gpils_continuous_case(world: int) -> dict:
    from ..agents import GPILSContinuous, GPILSContinuousConfig
    from ..envs import make

    support = [np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    cfg = GPILSContinuousConfig(num_envs=8, buffer_size=512, batch_size=16, hidden=(32, 32), learning_starts=16,
                                gradient_updates=2, max_support=4)

    def run(sharded: bool) -> dict:
        agent = GPILSContinuous(make("mo-mountaincarcontinuous-v0"), cfg, device=DEV)
        s = agent.set_weight_support(agent.init_state(0), support)
        if sharded:
            s = shard_agent_state(s, make_mesh(world, device=DEV), batched_fields=GPI_BATCHED)
        s = agent.train_segment(s, 10)
        if sharded:
            assert_replicas_synced(s.critic.net)  # BatchRenorm statistics included
            assert_replicas_synced(s.actor.net)
        return dict(critic=_params(s.critic.net), stats=[b.numpy().copy() for b in s.critic.net.buffers()],
                    actor_finite=all(bool(torch.isfinite(p).all()) for p in s.actor.net.parameters()))

    return dict(single=run(False), sharded=run(True))


def _morld_case(world: int) -> dict:
    from ..agents import MORLD, MORLDConfig, MOSACConfig
    from ..envs import make

    cfg = MORLDConfig(pop_size=4, exchange_every=64, update_passes=2, vectorized=True, weight_adaptation_method="PSA",
                      sac=MOSACConfig(num_envs=4, learning_starts=32, batch_size=32, buffer_size=2048, hidden=(32, 32)))

    def run(mesh) -> dict:
        algo = MORLD(make("mo-mountaincarcontinuous-v0"), cfg, device=DEV)
        state = algo.train(total_timesteps=512, ref_point=np.array([-120.0, -120.0]), mesh=mesh)
        return dict(archive=np.stack(algo.archive.evaluations), hv=algo._last_metrics["eval/hypervolume"],
                    leading=next(state.actor.parameters()).shape[0],
                    finite=all(bool(torch.isfinite(p).all()) for p in state.actor.parameters()),
                    weights=np.stack(algo.weights), actor=_params(state.actor))

    return dict(single=run(None), sharded=run(make_mesh(world, ("pop",), device=DEV)))


NOISY_ENVS = ("resource-gathering-v0", "minecart-v0", "water-reservoir-v0", "mo-lunar-lander-v3")


def _noise_case(world: int) -> dict:
    """Each env with step noise (and two of them under ``MOMaxAndSkipObservation``,
    whose noise carries the sub-steps in front of the env axis): 8 envs for
    ``steps`` vector steps of random actions, then one ``rollout_episode``,
    each sharded (the outputs all-gathered) and in one process from the same
    seed.  Returns, for each env, whether every gathered output equals the
    one-process one bit for bit, and how many episodes ended."""
    from ..envs import MOMaxAndSkipObservation, VectorMOEnv, make
    from ..evaluation.evaluation import rollout_episode
    from .mesh import gather_rows, mesh_shard

    n, steps = 8, 40
    shard = mesh_shard(make_mesh(world, device=DEV))
    envs = {name: make(name) for name in NOISY_ENVS}
    envs.update({f"max-and-skip({name})": MOMaxAndSkipObservation(make(name), skip=3)
                 for name in ("resource-gathering-v0", "mo-lunar-lander-v3")})

    def run(env, sh) -> list:
        def act(obs, w, gen):  # deterministic, so a row's action is the same on any rank
            if hasattr(env.action_space, "n"):
                return (obs.abs().sum(-1) * 1e3).long() % env.num_actions
            return torch.tanh(obs[:, : env.action_dim])

        vec = VectorMOEnv(env, n)
        gen, act_gen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
        state, _ = vec.reset(gen, sh)
        outs = []
        for _ in range(steps):
            action = local(sh, env.action_space.sample(act_gen, n))
            out = vec.step(state, action, gen, sh)
            state = out.state
            outs.append(gather_rows(sh, out[1:]))
        w = torch.full((n, env.reward_dim), 1.0 / env.reward_dim)
        outs.append(gather_rows(sh, rollout_episode(env, act, local(sh, w), gen, 0.99, 50, sh)))
        return outs

    out = {}
    for name, env in envs.items():
        if env.sample_noise(n, torch.Generator()) is None:
            raise AssertionError(f"{name} draws no step noise")
        single, sharded = run(env, None), run(env, shard)
        out[name] = dict(
            equal=all(torch.equal(a, b) for x, y in zip(single, sharded) for a, b in zip(x, y, strict=True)),
            episodes=int(sum(int((o[2] | o[3]).sum()) for o in single[:-1])),
        )
    return out


def run_cases(rank: int, world: int, out_dir: str) -> None:
    """Every case on this rank; the results to ``<out_dir>/rank<rank>.pt``."""
    torch.set_num_threads(1)
    results = {}
    for name, case in (("mesh", _mesh_case), ("envelope", _envelope_case), ("moql", _moql_case),
                       ("gpils", _gpils_case), ("gpils_continuous", _gpils_continuous_case), ("morld", _morld_case),
                       ("noise", _noise_case)):
        results[name] = case(world)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
