"""GPI-PD continuous-action — model-based GPI with prioritization (TD3), on torch.

PyTorch port of ``morl_baselines_tpu/agents/gpipd_continuous.py`` (reference
multi_policy/gpi_pd/gpi_pd_continuous_action.py:34-713 with ``dyna=True`` /
``per=True``), extending the port's ``GPILSContinuous`` with the model-based
machinery of ``DynaLoop``, composed as the discrete ``GPIPD``:

- a probabilistic-ensemble dynamics model on (obs ⊕ action) -> (Δobs ⊕
  reward_vec), fit every ``dynamics_train_freq`` env iterations, to
  convergence on the whole buffer or on a fixed budget (reference :487-500);
- Dyna: imagined rollouts from buffer states, actions from the conditioned
  actor under support-sampled weights plus exploration noise, transitions
  kept below an ensemble-uncertainty threshold in a second buffer, finished
  rows frozen (reference :502-539);
- updates draw mixed real + imagined batches, imagined rows standing in
  with real ones until the first rollout, the batch weights permuted
  (reference :541-560);
- PER with the w-scalarized TD priorities of ``GPILSContinuous._update``,
  reset to uniform when the task weight changes (reference :405-420,
  585-600).

Terminations inside imagined rollouts resolve from the env name
(``models.dynamics.get_termination_fn``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..envs.base import MOEnv
from ..models.dynamics import EnsembleConfig, EnsembleState, ModelEnv, ProbabilisticEnsemble, get_termination_fn
from ..replay.buffer import ReplayBuffer
from .gpils_continuous import GPILSContinuous, GPILSContinuousConfig, GPILSContState
from .gpipd import DynaLoop


@dataclass(frozen=True)
class GPIPDContinuousConfig(GPILSContinuousConfig):
    per: bool = True
    min_priority: float = 0.1
    per_alpha: float = 0.6
    dyna: bool = True
    dynamics_train_freq: int = 250  # env-iterations between model fits
    dynamics_rollout_freq: int = 250
    dynamics_rollout_len: int = 5
    dynamics_rollout_starts: int = 512
    dynamics_uncertainty_threshold: float = 2.0
    # the reference protocol: whole-buffer fit with holdout early stopping
    # (probabilistic_ensemble.py:196-290); False = the fixed-budget fit
    dynamics_fit_to_convergence: bool = True
    dynamics_fit_samples: int = 4096  # fixed-budget path only (and the fit gate)
    dyna_batch_share: float = 0.5  # fraction of each update batch from imagined data
    dyna_buffer_size: int = 50_000
    ensemble: EnsembleConfig = EnsembleConfig(num_members=5, num_elites=2, epochs=10)


@dataclass
class GPIPDContState:
    base: GPILSContState
    dyna_buffer: ReplayBuffer
    ens: EnsembleState


class GPIPDContinuous(DynaLoop, GPILSContinuous):
    def __init__(
        self,
        env: MOEnv,
        config: GPIPDContinuousConfig = GPIPDContinuousConfig(),
        log: bool = False,
        termination_fn: Callable | None = None,
        device="cuda",
    ):
        super().__init__(env, config, log=log, device=device)
        self.cfg: GPIPDContinuousConfig = config
        self.dynamics = ProbabilisticEnsemble(
            input_dim=self.obs_dim + self.action_dim,
            output_dim=self.obs_dim + self.reward_dim,
            cfg=config.ensemble,
            device=self.device,
        )
        self.model_env = ModelEnv(
            self.dynamics,
            termination_fn=termination_fn if termination_fn is not None else get_termination_fn(env.name),
        )

    def init_state(self, seed: int | None = None) -> GPIPDContState:  # type: ignore[override]
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        base = super().init_state(seed)
        if cfg.per:
            base.buffer = self._make_buffer(cfg.buffer_size, prioritized=True)
        return GPIPDContState(
            base=base, dyna_buffer=self._make_buffer(cfg.dyna_buffer_size), ens=self.dynamics.init_state(seed + 1)
        )

    # ------------------------------------------------------ DynaLoop's hooks

    def _rollout_actions(self, base: GPILSContState, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._explore(base.actor.net(obs, w), base.gen)

    def _on_new_task(self, state: GPIPDContState, w: np.ndarray) -> None:
        """Uniform priorities on a new task weight (reference :585-600)."""
        if self.cfg.per:
            state.base.buffer.reset_priorities()

    # ----------------------------------------------------------- learn phase

    def train_segment_pd(
        self, state: GPIPDContState, num_iters: int, change_w_every_episode: bool = True
    ) -> GPIPDContState:
        """GPILSContinuous segment whose updates draw mixed real + imagined
        batches and feed PER priorities back (reference :541-600), in place."""
        cfg = self.cfg
        base, gen = state.base, state.base.gen
        n_im = int(cfg.batch_size * cfg.dyna_batch_share) if cfg.dyna else 0
        n_real = cfg.batch_size - n_im
        for _ in range(num_iters):
            self._act_and_store(base, change_w_every_episode)
            if base.global_step >= cfg.learning_starts:
                for _ in range(cfg.gradient_updates):
                    batch, idx = self._mixed_batch(state, n_real, n_im)
                    # decorrelate the weights from the [real | imagined] batch order
                    w = self._batch_weights(base, cfg.batch_size)
                    w = w[torch.randperm(cfg.batch_size, generator=gen, device=gen.device)]
                    td_w = self._update(base, batch, w)
                    if cfg.per:
                        base.buffer.update_priorities(idx, torch.clamp(td_w[:n_real], min=cfg.min_priority) ** cfg.per_alpha)
        return state
