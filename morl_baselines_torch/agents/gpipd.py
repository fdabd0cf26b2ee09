"""GPI-PD — GPI with Prioritization and learned Dynamics, on torch.

PyTorch port of ``morl_baselines_tpu/agents/gpipd.py`` (reference
multi_policy/gpi_pd/gpi_pd.py:41-921; Alegre et al., 2023), extending the
port's GPILS with the model-based machinery:

- A probabilistic-ensemble dynamics model fit every ``dynamics_train_freq``
  env iterations on buffer data (reference :748-754).
- Dyna: imagined rollouts from buffer states, actions by the GPI policy under
  sampled support weights, transitions kept below an ensemble-uncertainty
  threshold in a second (imagined) buffer (reference :367-414, 760-761).
- Updates draw mixed real + imagined batches (reference
  _sample_batch_experiences :343-365).
- The namesake prioritization (``gpi_pd=True``): PER priorities are the
  envelope-target GTD errors |w·(psi(s,a,w) − r − γ·max_{w'∈M,a'} min_c
  psi_c(s',a',w'))|^α computed at update time (reference :465-530), and on
  every new task weight the priorities of the whole buffer are recomputed
  against it (reference _reset_priorities :619-660).

The host runs sub-segments between the dynamics phases, as in the JAX
package; the fit, the rollout and the priority recompute are each a few
batched tensor programs on the device.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.weights import equally_spaced_weights
from ..envs.base import MOEnv
from ..models.dynamics import EnsembleConfig, EnsembleState, ModelEnv, ProbabilisticEnsemble, get_termination_fn
from ..models.networks import TrainState, polyak_update
from ..outer.linear_support import LinearSupport
from ..replay.buffer import ReplayBuffer, Transition
from ..utils.schedules import unique_tol
from .gpils import GPILS, GPILSConfig, GPILSState


@dataclass(frozen=True)
class GPIPDConfig(GPILSConfig):
    per: bool = True
    gpi_pd: bool = True  # envelope-target GTD priorities — the "PD" (reference gpi_pd.py:466,507-530)
    full_updates_after: int = 0  # env-steps before which each learn step does 1 update
    # (reference update() :419 runs a single gradient update until
    # global_step >= dynamics_rollout_starts=5000; 0 disables the warmup)
    dyna: bool = True
    dynamics_train_freq: int = 250  # env-iterations between model fits
    dynamics_rollout_freq: int = 250
    dynamics_rollout_len: int = 1
    dynamics_rollout_starts: int = 512
    dynamics_uncertainty_threshold: float = 0.5
    # reference protocol: fit the WHOLE buffer to convergence (holdout early
    # stopping) every refit (probabilistic_ensemble.py:196-290)
    dynamics_fit_to_convergence: bool = True
    dynamics_fit_samples: int = 4096  # fixed-budget path only (and the fit gate)
    # >0: rare positive-reward rows get (1 + this) NLL loss weight in the
    # convergence fit; 0.0 = the reference's uniform loss.
    dynamics_fit_positive_weight: float = 0.0
    dyna_batch_share: float = 0.5  # fraction of each update batch from imagined data
    dyna_buffer_size: int = 50_000
    ensemble: EnsembleConfig = EnsembleConfig(num_members=5, num_elites=2, epochs=10)


@dataclass
class GPIPDState:
    base: GPILSState
    dyna_buffer: ReplayBuffer
    ens: EnsembleState


class DynaLoop:
    """The GPI-PD outer loop shared by the discrete and continuous agents: the
    LinearSupport loop of ``LinearSupportLoop`` whose inner iterations run in
    sub-segments punctuated by dynamics fits and imagined rollouts.  The
    agent supplies ``dynamics``, ``model_env``, ``train_segment_pd``,
    ``_rollout_actions`` (the policy's actions in imagined rollouts) and
    ``_on_new_task`` (the PER priorities on a new task weight); its state has
    ``base``, ``dyna_buffer`` and ``ens``."""

    def _model_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """Buffer actions as the dynamics model's inputs."""
        return actions

    def _fit_row_weights(self, data: Transition) -> torch.Tensor | None:
        """Per-row NLL weights of the convergence fit; None is the reference's uniform loss."""
        return None

    # ----------------------------------------------------------- model phase

    def fit_dynamics(self, state):
        """Fit the ensemble on real transitions (reference :748-754), in place;
        returns (state, loss).

        Default (``dynamics_fit_to_convergence``): the reference's protocol —
        the whole buffer with per-member bootstrap and holdout early stopping
        (loss: the mean holdout MSE).  Otherwise a fixed-budget fit on
        ``dynamics_fit_samples`` uniformly sampled rows (uniform even under
        PER: the model must fit the data distribution, not the TD-error
        distribution; loss: the mean training NLL)."""
        buf, gen = state.base.buffer, state.base.gen
        if self.cfg.dynamics_fit_to_convergence:
            data = buf.data
            X = torch.cat([data.obs, self._model_actions(data.action)], dim=-1)
            Y = torch.cat([data.next_obs - data.obs, data.reward], dim=-1)
            state.ens, loss, _epochs = self.dynamics.fit_converged(state.ens, X, Y, buf.size, gen, self._fit_row_weights(data))
            return state, loss
        idx = torch.randint(0, max(buf.size, 1), (self.cfg.dynamics_fit_samples,), generator=gen, device=gen.device)
        batch = buf.gather(idx)
        X = torch.cat([batch.obs, self._model_actions(batch.action)], dim=-1)
        Y = torch.cat([batch.next_obs - batch.obs, batch.reward], dim=-1)
        state.ens, loss = self.dynamics.fit(state.ens, X, Y, gen)
        return state, loss

    @torch.no_grad()
    def rollout_dynamics(self, state):
        """Imagined rollouts of the agent's policy, filtered by uncertainty
        (reference gpi_pd.py:367-414), in place; returns (state, mean uncertainty)."""
        cfg = self.cfg
        base, gen, dyna = state.base, state.base.gen, state.dyna_buffer
        starts = cfg.dynamics_rollout_starts
        obs = base.buffer.sample_obs(gen, starts)
        w = base.support[torch.randint(0, base.support_size, (starts,), generator=gen, device=gen.device)]
        alive = torch.ones((starts,), dtype=torch.bool, device=self.device)
        rows = torch.arange(starts, device=self.device)
        mean_unc = []
        for _ in range(cfg.dynamics_rollout_len):
            actions = self._rollout_actions(base, obs, w)
            next_obs, reward, term, unc = self.model_env.step(state.ens, obs, self._model_actions(actions), gen)
            # rollouts stop at termination (reference nonterm_mask,
            # gpi_pd.py:395-399): the terminal transition itself is kept, but
            # finished rows are frozen and never stepped or stored again.
            keep = (unc <= cfg.dynamics_uncertainty_threshold) & alive
            # as in the JAX package (static shapes there): a dropped row is
            # written as a copy of the first kept row, and nothing is written
            # when no row is kept
            if bool(keep.any()):
                repl = torch.where(keep, rows, torch.argmax(keep.to(torch.uint8)))
                dyna.add_batch(
                    Transition(
                        obs=obs[repl],
                        action=actions[repl],
                        reward=reward[repl],
                        next_obs=next_obs[repl],
                        terminated=term.to(torch.float32)[repl],
                    )
                )
            alive = alive & ~term
            obs = torch.where(alive[:, None], next_obs, obs)
            mean_unc.append(unc.mean())
        return state, torch.stack(mean_unc).mean()

    def _mixed_batch(self, state, n_real: int, n_im: int):
        """[real | imagined] rows; returns (batch, real row indices for PER or None).

        Before any imagined data exists, real rows stand in for it (tiled
        when n_im > n_real)."""
        base = state.base
        gen = base.gen
        if self.cfg.per:
            real, idx, _ = base.buffer.sample(gen, n_real)
        else:
            real, idx = base.buffer.sample(gen, n_real), None
        if n_im == 0:
            return real, idx
        if state.dyna_buffer.size > 0:
            im = state.dyna_buffer.sample(gen, n_im)
        else:
            ridx = torch.arange(n_im, device=self.device) % n_real
            im = Transition(*(x[ridx] for x in real))
        return Transition(*(torch.cat([a, b]) for a, b in zip(real, im))), idx

    @torch.no_grad()
    def _diagnostics(self, state) -> dict:
        """Are the rare positive-reward transitions (minecart ore sales) in the
        real and imagined data, and does PER weight them?"""
        buf = state.base.buffer
        n = buf.size
        pos_rows = torch.any(buf.data.reward[:n] > 0, dim=-1)
        diag = {
            "diag/buffer_positive_reward_rows": int(pos_rows.sum()),
            "diag/buffer_size": int(n),
        }
        if self.cfg.per:
            prios = buf.priorities[:n]
            if bool(pos_rows.any()):
                diag["diag/mean_priority_positive_rows"] = float(prios[pos_rows].mean())
            diag["diag/mean_priority_all"] = float(prios.mean()) if n > 0 else 0.0
        if self.cfg.dyna:
            dbuf = state.dyna_buffer
            dn = dbuf.size
            diag.update(
                {
                    "diag/dyna_size": int(dn),
                    "diag/dyna_positive_reward_rows": int(torch.any(dbuf.data.reward[:dn] > 0.1, dim=-1).sum()),
                    "diag/dyna_terminated_rows": int(dbuf.data.terminated[:dn].sum()),
                }
            )
        return diag

    # ---------------------------------------------------------- orchestration

    def train(  # type: ignore[override]
        self,
        total_timesteps: int,
        ref_point: np.ndarray | None = None,
        known_pareto_front: np.ndarray | None = None,
        num_eval_weights_for_front: int = 32,
        num_eval_episodes_for_front: int = 1,
        timesteps_per_iter: int = 10_000,
        weight_selection_algo: str = "gpi-ls",
        eval_max_steps: int | None = None,
        state=None,
    ):
        """GPI-PD outer loop: LinearSupport + per-sub-segment dynamics phases."""
        state = state if state is not None else self.init_state()
        cfg = self.cfg
        rep, algo = num_eval_episodes_for_front, weight_selection_algo
        max_steps = eval_max_steps or self.env.max_episode_steps or 500
        linear_support = LinearSupport(num_objectives=self.reward_dim, epsilon=0.0 if algo == "ols" else None)
        self._rng = random.Random(cfg.seed)
        eval_weights = equally_spaced_weights(self.reward_dim, num_eval_weights_for_front).astype(np.float32)
        max_iter = max(1, total_timesteps // timesteps_per_iter)
        t0 = time.time()
        # steps-since counters (persist across outer iterations) instead of a
        # modulo on the per-iteration clock: with unequal freqs the modulo only
        # fires when freq is a multiple of the sub-segment stride.  They start
        # at their freqs so the first eligible check fires.
        since_fit = cfg.dynamics_train_freq
        since_rollout = cfg.dynamics_rollout_freq
        for _ in range(max_iter):
            base = state.base
            w = self._next_weight(base, linear_support, algo, rep, max_steps)
            if w is None:
                break
            M = self._corner_support(linear_support, w, algo)
            self.set_weight_support(base, M)
            base.task_w = torch.as_tensor(w, dtype=torch.float32, device=self.device).repeat(base.task_w.shape[0], 1)
            self._on_new_task(state, w)

            # sub-segments punctuated by dynamics fits and rollouts on their
            # own cadences (reference dynamics_train_freq / dynamics_rollout_freq)
            iters = max(1, timesteps_per_iter // cfg.num_envs)
            sub = max(1, min(cfg.dynamics_train_freq, cfg.dynamics_rollout_freq, iters))
            done_iters = 0
            while done_iters < iters:
                n = min(sub, iters - done_iters)
                if cfg.dyna and base.buffer.size >= cfg.dynamics_fit_samples // 4:
                    if since_fit >= cfg.dynamics_train_freq:
                        self.fit_dynamics(state)
                        since_fit -= cfg.dynamics_train_freq
                    if since_rollout >= cfg.dynamics_rollout_freq:
                        self.rollout_dynamics(state)
                        since_rollout -= cfg.dynamics_rollout_freq
                self.train_segment_pd(state, n, algo == "gpi-ls")
                done_iters += n
                since_fit += n
                since_rollout += n

            self.logger.log(self._diagnostics(state), base.global_step)

            M_arr = np.stack(unique_tol([np.asarray(m) for m in M]))
            for wcw, val in zip(M_arr, self._eval_np(base, M_arr, rep, max_steps)):
                linear_support.add_solution(val, wcw)
            self.set_weight_support(base, linear_support.get_weight_support())

            if ref_point is not None:
                self._log_front(base, eval_weights, rep, max_steps, ref_point, known_pareto_front, t0)
        self._linear_support = linear_support
        return state


class GPIPD(DynaLoop, GPILS):
    def __init__(
        self,
        env: MOEnv,
        config: GPIPDConfig = GPIPDConfig(),
        log: bool = False,
        termination_fn=None,
        device="cuda",
    ):
        super().__init__(env, config, log=log, device=device)
        self.cfg: GPIPDConfig = config
        # model input: obs ⊕ one-hot action; output: delta_obs ⊕ reward_vec
        self.dynamics = ProbabilisticEnsemble(
            input_dim=self.obs_dim + env.num_actions,
            output_dim=self.obs_dim + self.reward_dim,
            cfg=config.ensemble,
            device=self.device,
        )
        self.model_env = ModelEnv(
            self.dynamics,
            termination_fn=termination_fn if termination_fn is not None else get_termination_fn(env.name),
        )

    def init_state(self, seed: int | None = None) -> GPIPDState:  # type: ignore[override]
        seed = self.cfg.seed if seed is None else seed
        dyna_buffer = ReplayBuffer.create(
            self.cfg.dyna_buffer_size, obs_dim=self.obs_dim, reward_dim=self.reward_dim, device=self.device
        )
        return GPIPDState(base=super().init_state(seed), dyna_buffer=dyna_buffer, ens=self.dynamics.init_state(seed + 1))

    def _model_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """The dynamics model sees a one-hot action."""
        return F.one_hot(actions.long(), self.env.num_actions).to(torch.float32)

    def _rollout_actions(self, base: GPILSState, obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._gpi_actions(base.ts.net, obs, w, base.valid_support)

    def _fit_row_weights(self, data: Transition) -> torch.Tensor | None:
        """(1 + dynamics_fit_positive_weight) NLL weight on positive-reward rows, or None."""
        if self.cfg.dynamics_fit_positive_weight <= 0:
            return None
        return 1.0 + self.cfg.dynamics_fit_positive_weight * torch.any(data.reward > 0, dim=-1).to(torch.float32)

    # ----------------------------------------------------------- learn phase

    @torch.no_grad()
    def _envelope_target(self, target_net, next_obs: torch.Tensor, w: torch.Tensor, support: torch.Tensor):
        """Envelope next-value: max over (support policy, action) of the
        min-over-critics psi at next_obs (reference _envelope_target
        gpi_pd.py:662-690), over the full valid ``support`` (M, d) in one
        (B·M)-row forward.  No dropout, float32: it feeds priorities only."""
        b, m, d = next_obs.shape[0], support.shape[0], self.reward_dim
        psi = target_net(next_obs.repeat_interleave(m, dim=0), support.repeat(b, 1))
        psi = psi.reshape(psi.shape[0], b, m, -1, d)  # (C, B, M, A, d)
        q = torch.einsum("bd,cbmad->cbma", w, psi)
        min_inds = torch.argmin(q, dim=0)  # (B, M, A) — min over critics
        min_psi = torch.gather(psi, 0, min_inds[None, ..., None].expand(1, -1, -1, -1, d)).squeeze(0)
        q2 = torch.einsum("bd,bmad->bma", w, min_psi)
        ac = torch.argmax(q2, dim=2)  # (B, M) best action per support policy
        pi = torch.argmax(q2.max(dim=2).values, dim=1)  # (B,) best support policy
        rows = torch.arange(b, device=w.device)
        return min_psi[rows, pi, ac[rows, pi]]  # (B, d)

    def _update_pd(self, ts: TrainState, batch: Transition, w, support, gen):
        """GPILS TD step + envelope-target GTD errors (reference :465-530).

        The loss is the plain TD loss (the envelope target feeds ONLY the
        priorities, reference :483-486 vs :507-530).  gtd = psi(s,a,w) −
        (r + γ(1−done)·envelope); priority base |w·(max_c |gtd_c|)|.
        Returns (loss, td_w, gtd_w).
        """
        cfg = self.cfg
        loss, tds, target_psi = self._update_with_aux(ts, batch, w, gen)
        td_w = torch.einsum("cbd,bd->cb", tds, w).abs().max(dim=0).values
        if not cfg.gpi_pd:
            return loss, td_w, td_w
        env_next = self._envelope_target(ts.target_net, batch.next_obs, w, support)
        target_env = batch.reward + (1.0 - batch.terminated[:, None]) * cfg.gamma * env_next
        # psi_sa − target_env = tds + (target_psi − target_env); tds are the
        # pre-gradient psi_sa − target_psi, as in the reference (:476-487)
        gtd = torch.abs(tds + (target_psi - target_env)[None]).max(dim=0).values  # per-dim max over critics
        return loss, td_w, torch.abs(torch.einsum("bd,bd->b", w, gtd))

    recompute_chunk = 4096  # buffer rows per forward of the priority recompute

    @torch.no_grad()
    def recompute_priorities(self, state: GPIPDState, w: torch.Tensor) -> GPIPDState:
        """Recompute the priority of every buffer row against a new task
        weight (reference _reset_priorities gpi_pd.py:619-660), in place.

        Chunks of ``recompute_chunk`` rows, the first critic only.  With gpi_pd the next
        value is the envelope target over the current support, otherwise the
        DDQN target.  Rows beyond ``size`` get 0; the running max priority is
        floored at min_priority ** alpha.
        """
        cfg = self.cfg
        base = state.base
        buf, ts = base.buffer, base.ts
        prios = torch.zeros_like(buf.priorities)
        for start in range(0, buf.size, self.recompute_chunk):
            b = buf.gather(torch.arange(start, min(start + self.recompute_chunk, buf.size), device=self.device))
            wt = w[None].expand(b.obs.shape[0], -1)
            rows = torch.arange(b.obs.shape[0], device=self.device)
            q_a = ts.net(b.obs, wt)[0][rows, b.action.long()]  # first critic (B, d)
            if cfg.gpi_pd:
                max_next_q = self._envelope_target(ts.target_net, b.next_obs, wt, base.valid_support)
            else:
                acts = torch.argmax(torch.einsum("d,bad->ba", w, ts.net(b.next_obs, wt)[0]), dim=1)
                max_next_q = ts.target_net(b.next_obs, wt)[0][rows, acts]
            gtd = torch.abs((b.reward + (1.0 - b.terminated[:, None]) * cfg.gamma * max_next_q - q_a) @ w)
            prios[start : start + b.obs.shape[0]] = torch.clamp(gtd, min=cfg.min_priority) ** cfg.per_alpha
        buf.priorities = prios
        buf.max_priority = torch.clamp(prios.max(), min=cfg.min_priority**cfg.per_alpha)
        return state

    def train_segment_pd(self, state: GPIPDState, num_iters: int, change_w_every_episode: bool = True) -> GPIPDState:
        """GPILS segment whose updates draw mixed real + imagined batches, in place."""
        cfg = self.cfg
        base = state.base
        ts, gen = base.ts, base.gen
        n_im = int(cfg.batch_size * cfg.dyna_batch_share) if cfg.dyna else 0
        n_real = cfg.batch_size - n_im
        for _ in range(num_iters):
            greedy = self._gpi_actions(ts.net, base.obs, base.task_w, base.valid_support)
            self._step_and_store(base, self._epsilon_greedy(base, greedy), change_w_every_episode)

            if base.global_step >= cfg.learning_starts and base.iter_count % cfg.train_freq == 0:
                # single gradient update until the warmup step threshold
                # (reference update() :419: 1 update before
                # dynamics_rollout_starts, gradient_updates after)
                warm = cfg.full_updates_after > 0 and base.global_step < cfg.full_updates_after
                for _ in range(1 if warm else cfg.gradient_updates):
                    batch, idx = self._mixed_batch(state, n_real, n_im)
                    w = self._batch_weights(base, cfg.batch_size)
                    # decorrelate the weights from data provenance: the batch
                    # is [real | imagined] in order, so without this
                    # permutation the support-weight Qs (which drive GPI and
                    # the envelope target) would train only on imagined rows
                    # (the reference builds its weight batch independently of
                    # the real/imagined mix, gpi_pd.py:425-438)
                    w = w[torch.randperm(cfg.batch_size, generator=gen, device=gen.device)]
                    base.loss, td_w, gtd_w = self._update_pd(ts, batch, w, base.valid_support, gen)
                    if cfg.per:
                        # gpi_pd: the envelope-target GTD error IS the priority
                        # (reference :525-530 updates gpriority, not priority)
                        pr = gtd_w if cfg.gpi_pd else td_w
                        base.buffer.update_priorities(idx, torch.clamp(pr[:n_real], min=cfg.min_priority) ** cfg.per_alpha)

            if base.iter_count % cfg.target_net_update_freq == 0:
                polyak_update(ts.net, ts.target_net, 1.0)
        return state

    # ---------------------------------------------------------- orchestration

    def _on_new_task(self, state: GPIPDState, w: np.ndarray) -> None:
        """Per-transition priority recompute against the new task weight over
        the whole buffer (reference _reset_priorities :619-660)."""
        if self.cfg.per and state.base.buffer.size > 0:
            self.recompute_priorities(state, torch.as_tensor(w, dtype=torch.float32, device=self.device))
