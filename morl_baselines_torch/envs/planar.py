"""Planar mo-hopper and mo-halfcheetah, batched on torch, closed-form dynamics.

PyTorch port of ``morl_baselines_tpu/envs/planar.py``: the same planar
(x, z, rotation about y) articulated chains, generalized coordinates q equal
to MuJoCo's qpos, penalty ground contact with tanh-regularized Coulomb
friction, stiff one-sided joint limits and semi-implicit Euler substeps, with
the same observations, rewards, termination, reset noise and
``frame_skip``/``n_sub``.  The constants are ``planar_models.py``'s.

The JAX package derives the equations of motion by autodiff of the kinetic
and potential energy.  Here they are written out, as a fixed sequence of ops
batched over the N envs.  The chain is planar, so:

- body b's angle is the signed sum of its ancestors' hinge displacements,
  ``alpha = (q - qpos0) @ A``, and its angular Jacobian is the constant
  column ``A[:, b]``;
- every point of interest (each body's centre of mass, each contact sphere)
  sits at ``const + q[:2] + sum_k R(alpha_k) v_k`` for constant 2-vectors v_k,
  so its position, velocity, velocity-product acceleration and Jacobian
  (``sign_j * perp(p - anchor_j)`` for hinge j, the identity for the root's x
  and z) are all linear in the features (cos alpha, sin alpha, their first
  and second time derivatives at zero angular acceleration, 1, q[:2],
  qd[:2]); one GEMM against a constant matrix gives all of them;
- the mass matrix is ``sum_b m_b J_b^T J_b + I_b A_b A_b^T + diag(armature)``;
- ``(dp/dq) qd - dT/dq`` in the JAX package's ``_qdd`` equals
  ``sum_b m_b J_b^T (Jdot_b qd)``, because the angular Jacobian is constant;
  gravity adds ``m_b g`` to the z row of that acceleration, and the springs
  ``stiffness * (q - qpos_spring)``;
- contact forces enter through the contact points' Jacobians, transposed;
  joint limits are elementwise.

``M qdd = rhs`` is solved by Gauss-Jordan elimination unrolled over the DOF
count (M is SPD, no pivoting), as the JAX package does: batched elementwise
ops, no host synchronisation.  A hopper control step is a few hundred
kernel launches (``chip_smoke.py``'s ``[planar]`` phase counts them), where
a port of the autodiff formulation would launch one per primitive of its
jaxpr.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import Box, MOEnv, StepOut
from .planar_models import HALF_CHEETAH, HOPPER, PlanarModel

_G = 9.81


class PlanarState(NamedTuple):
    q: torch.Tensor  # (N, nq)
    qd: torch.Tensor  # (N, nq)
    t: torch.Tensor  # (N,) int32


def _chain(parent: tuple, b: int) -> list[int]:
    """Bodies from the root down to b."""
    out = [b]
    while parent[out[-1]] >= 0:
        out.append(parent[out[-1]])
    return out[::-1]


def _point_terms(m: PlanarModel, b: int, u: np.ndarray):
    """A point at local position u on body b as ``c + q[:2] - qpos0[:2] + sum_k R(alpha_k) v_k``:
    returns (c (2,), {k: v_k}) in float64."""
    f64 = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    chain = _chain(m.parent, b)
    root = chain[0]
    c = f64(m.body_pos[root]) + f64(m.jnt_pos[root])
    v = {root: -f64(m.jnt_pos[root])}
    for j in chain[1:]:
        p = m.parent[j]
        v[p] = v[p] + f64(m.body_pos[j]) + f64(m.jnt_pos[j])
        v[j] = -f64(m.jnt_pos[j])
    v[b] = v[b] + f64(u)
    return c, v, chain


class PlanarDynamics:
    """The constant matrices of one model on one device, and the batched
    equations of motion.

    Features F (N, 6nb + 5) = [cos a, sin a, sin a * ad, cos a * ad,
    cos a * ad^2, sin a * ad^2, 1, q0, q1, qd0, qd1]; ``F @ K`` gives, per
    contact sphere, its penetration, the unclipped normal force
    kp*pen - kd*vz and vx / v_slip, the contact Jacobians (nc, 2, nq), and per
    body X (nb, 2, nq + 1): the centre of mass's Jacobian rows beside
    -(Jdot qd + g z).
    """

    def __init__(self, m: PlanarModel, device, kp: float, kd: float, v_slip: float, k_lim: float, d_lim: float):
        nb, nq, nc = len(m.parent), m.nq, len(m.cp_body)
        self.nb, self.nq, self.nc = nb, nq, nc
        self.k_lim, self.d_lim = k_lim, d_lim
        sign = m.jnt_sign.astype(np.float64)

        A = np.zeros((nq, nb))
        for b in range(nb):
            for j in _chain(m.parent, b):
                A[m.jnt_dof[j], b] = sign[j]

        n_feat = 6 * nb + 5
        ONE, Q0, Q1, QD0, QD1 = 6 * nb, 6 * nb + 1, 6 * nb + 2, 6 * nb + 3, 6 * nb + 4
        cos_, sin_, sad, cad, cad2, sad2 = (slice(i * nb, (i + 1) * nb) for i in range(6))
        q0_xz = m.qpos0[:2].astype(np.float64)

        def position_rows(c, v, axis):
            """Coefficients of a point's x (axis 0) or z (axis 1) in F."""
            col = np.zeros(n_feat)
            for k, vk in v.items():
                vx, vz = vk
                col[cos_][k], col[sin_][k] = (vx, vz) if axis == 0 else (vz, -vx)
            col[ONE] = c[axis] - q0_xz[axis]
            col[Q0 + axis] = 1.0
            return col

        def velocity_rows(v, axis):
            col = np.zeros(n_feat)
            for k, vk in v.items():
                vx, vz = vk
                # d/dt cos = -sin * ad, d/dt sin = cos * ad
                col[sad][k], col[cad][k] = (-vx, vz) if axis == 0 else (-vz, -vx)
            col[QD0 + axis] = 1.0
            return col

        def jacobian_rows(v, chain, axis):
            """(n_feat, nq): d(point)/dq along ``axis``."""
            cols = np.zeros((n_feat, nq))
            for i, j in enumerate(chain):
                for k in chain[i:]:
                    vx, vz = v[k]
                    s = sign[j]
                    if axis == 0:  # s_j * (z of R(a_k) v_k)
                        cols[cos_.start + k, m.jnt_dof[j]] += s * vz
                        cols[sin_.start + k, m.jnt_dof[j]] += -s * vx
                    else:  # -s_j * (x of R(a_k) v_k)
                        cols[cos_.start + k, m.jnt_dof[j]] += -s * vx
                        cols[sin_.start + k, m.jnt_dof[j]] += -s * vz
            cols[ONE, axis] = 1.0
            return cols

        pen_cols, fn_cols, vxs_cols, jc_cols = [], [], [], []
        for i, b in enumerate(m.cp_body):
            c, v, chain = _point_terms(m, b, m.cp_local[i])
            pen = -position_rows(c, v, 1)
            pen[ONE] += float(m.cp_radius[i])
            pen_cols.append(pen)
            fn_cols.append(kp * pen - kd * velocity_rows(v, 1))
            vxs_cols.append(velocity_rows(v, 0) / v_slip)
            jc_cols += [jacobian_rows(v, chain, 0), jacobian_rows(v, chain, 1)]
        x_cols = []
        for b in range(nb):
            c, v, chain = _point_terms(m, b, m.ipos[b])
            for axis in (0, 1):
                acc = np.zeros(n_feat)  # -(Jdot qd + g z): d^2/dt^2 cos = -cos ad^2, sin -> -sin ad^2
                for k, (vx, vz) in v.items():
                    acc[cad2][k], acc[sad2][k] = (vx, vz) if axis == 0 else (vz, -vx)
                if axis == 1:
                    acc[ONE] = -_G
                x_cols.append(np.concatenate([jacobian_rows(v, chain, axis), acc[:, None]], axis=1))
        K = np.concatenate(
            [np.stack(pen_cols, 1), np.stack(fn_cols, 1), np.stack(vxs_cols, 1)]
            + [np.concatenate(jc_cols, 1), np.concatenate(x_cols, 1)],
            axis=1,
        )

        m_const = np.diag(m.armature.astype(np.float64)) + np.einsum("b,ib,jb->ij", m.inertia.astype(np.float64), A, A)
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)  # noqa: E731
        self.A = f32(A)
        self.alpha0 = f32(-m.qpos0.astype(np.float64) @ A)
        self.K = f32(K)
        self.M_aug = f32(np.concatenate([m_const, np.zeros((nq, 1))], axis=1))  # [M_const | 0]
        self.m_rows = f32(np.repeat(m.mass, 2)[:, None])  # (2nb, 1): each body's mass on its x and z rows
        self.neg_mu = f32(-m.cp_mu)
        self.neg_damping = f32(-m.damping)
        self.neg_stiffness = f32(-m.stiffness) if np.any(m.stiffness) else None
        self.qpos_spring = f32(m.qpos_spring)
        self.lo, self.hi = f32(m.jnt_lo), f32(m.jnt_hi)
        gear = np.zeros((m.nu, nq), dtype=np.float32)
        gear[np.arange(m.nu), list(m.act_dof)] = m.gear
        self.gear = f32(gear)  # (nu, nq): clip(a) @ gear puts each actuator's torque on its DOF
        self.not_k = f32(1.0 - np.eye(nq))[:, :, None]  # (nq, nq, 1): row k of it zeroes row k's factor

    # ------------------------------------------------------------------ terms

    def features_out(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """F @ K: (N, 3nc + 2nc*nq + 2nb*(nq + 1))."""
        a = torch.addmm(self.alpha0, q, self.A)
        ad = qd @ self.A
        c, s = torch.cos(a), torch.sin(a)
        ad2 = ad * ad
        ones = torch.ones_like(ad[:, :1])
        feats = torch.cat([c, s, s * ad, c * ad, c * ad2, s * ad2, ones, q[:, :2], qd[:, :2]], dim=1)
        return feats @ self.K

    def _split(self, out: torch.Tensor):
        n, nc, nq, nb = out.shape[0], self.nc, self.nq, self.nb
        o = 3 * nc + 2 * nc * nq
        return (
            out[:, :nc],  # penetration
            out[:, nc : 2 * nc],  # kp * pen - kd * vz
            out[:, 2 * nc : 3 * nc],  # vx / v_slip
            out[:, 3 * nc : o].view(n, 2 * nc, nq),  # contact Jacobians, rows (sphere, axis)
            out[:, o:].view(n, 2 * nb, nq + 1),  # [J_com | -(Jdot qd + g z)], rows (body, axis)
        )

    def contact_tau(self, out: torch.Tensor) -> torch.Tensor:
        """Generalized ground-contact forces J_c^T f: penalty normal force, smooth friction."""
        pen, fn_raw, vxs, jc, _ = self._split(out)
        fn = torch.where(pen > 0.0, fn_raw, 0.0).clamp_min_(0.0)
        ft = fn * torch.tanh(vxs) * self.neg_mu
        f = torch.stack([ft, fn], dim=-1).view(out.shape[0], 1, -1)
        return torch.bmm(f, jc).view(out.shape[0], -1)

    def limit_tau(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """Stiff one-sided joint limits with damping while violated."""
        e = torch.clamp(q, self.lo, self.hi) - q  # under - over
        return self.k_lim * e - torch.where(e != 0.0, self.d_lim * qd, 0.0)

    def augmented(self, out: torch.Tensor, rhs_ext: torch.Tensor) -> torch.Tensor:
        """[M | rhs] (N, nq, nq + 1), rhs = rhs_ext - sum_b m_b J_b^T (Jdot_b qd + g z)."""
        x = self._split(out)[4]
        aug = torch.baddbmm(self.M_aug, (x[:, :, : self.nq] * self.m_rows).transpose(1, 2), x)
        aug[:, :, self.nq] += rhs_ext
        return aug

    def spring_tau(self, q: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        """tau - stiffness * (q - qpos_spring)."""
        if self.neg_stiffness is None:
            return tau
        return torch.addcmul(tau, q - self.qpos_spring, self.neg_stiffness)

    def solve(self, aug: torch.Tensor) -> torch.Tensor:
        """Gauss-Jordan on [M | rhs] unrolled over nq, as the JAX package's ``_solve_unrolled``."""
        for k in range(self.nq):
            row = aug[:, k, :] / aug[:, k, k : k + 1]
            factors = aug[:, :, k : k + 1] * self.not_k[k]
            aug = torch.addcmul(aug, factors, row[:, None, :], value=-1.0)
            aug[:, k, :] = row
        return aug[:, :, self.nq]

    def substep(self, q: torch.Tensor, qd: torch.Tensor, act_tau: torch.Tensor, dt: float):
        out = self.features_out(q, qd)
        tau = torch.addcmul(act_tau, qd, self.neg_damping)
        tau = self.spring_tau(q, tau + self.limit_tau(q, qd) + self.contact_tau(out))
        qd = torch.add(qd, self.solve(self.augmented(out, tau)), alpha=dt)
        q = torch.add(q, qd, alpha=dt)
        return q, qd


class PlanarMOEnv(MOEnv):
    """Generic planar locomotion MOEnv: substepped semi-implicit Euler.

    The env's constants live on ``device`` (CUDA unless asked otherwise;
    raises where there is no card); its states are (N, ...) tensors there.
    The dynamics are deterministic: ``sample_noise`` returns None.
    """

    # contact/limit penalty parameters (per-env overrides below)
    kp: float = 2.0e4
    kd: float = 400.0
    v_slip: float = 0.05
    k_lim: float = 4000.0
    d_lim: float = 40.0
    reset_noise: float = 5e-3
    n_sub: int = 4  # integration substeps per control step
    frame_skip: int = 4

    def __init__(self, model: PlanarModel, name: str, max_episode_steps: int = 1000, device="cuda"):
        self.device = resolve_device(device)
        self._mj_dt, self.nq, self.nu = model.timestep, model.nq, model.nu
        self.name = name
        self.max_episode_steps = max_episode_steps
        self.action_space = Box(low=tuple(-np.ones(self.nu)), high=tuple(np.ones(self.nu)))
        self.dyn = PlanarDynamics(model, self.device, self.kp, self.kd, self.v_slip, self.k_lim, self.d_lim)
        self._qpos0 = torch.as_tensor(model.qpos0, device=self.device)

    @property
    def _dt_int(self) -> float:
        """Integration dt: frame_skip MuJoCo steps split into n_sub substeps."""
        return self._mj_dt * self.frame_skip / self.n_sub

    def physics(self, q: torch.Tensor, qd: torch.Tensor, action: torch.Tensor):
        """``n_sub`` substeps under the clipped action's torques."""
        act_tau = torch.clamp(action, -1.0, 1.0) @ self.dyn.gear
        for _ in range(self.n_sub):
            q, qd = self.dyn.substep(q, qd, act_tau, self._dt_int)
        return q, qd

    def reset(self, n: int, gen: torch.Generator):
        dev, r = gen.device, self.reset_noise
        q = self._qpos0 + (torch.rand((n, self.nq), generator=gen, device=dev) * (2 * r) - r)
        qd = torch.rand((n, self.nq), generator=gen, device=dev) * (2 * r) - r
        s = PlanarState(q, qd, torch.zeros((n,), dtype=torch.int32, device=dev))
        return s, self._obs(s)

    # subclasses: _obs, _mo_reward, _terminated

    def step(self, state: PlanarState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        a = action.to(torch.float32).reshape(-1, self.nu)
        x_before = state.q[:, 0]
        q, qd = self.physics(state.q, state.qd, a)
        t = state.t + 1
        s = PlanarState(q, qd, t)
        vx = (q[:, 0] - x_before) / (self._mj_dt * self.frame_skip)
        return StepOut(s, self._obs(s), self._mo_reward(s, a, vx), self._terminated(s), t >= self.max_episode_steps)


class MOHopperJX(PlanarMOEnv):
    """mo-hopper (3 objectives; gymnasium Hopper-v5 physics).

    Observation = [qpos[1:], clip(qvel, ±10)] (11,), actions 3, healthy
    termination as gymnasium (z > 0.7, |angle| < 0.2, |state[2:]| < 100).
    Rewards: forward velocity, 10 * (height - 1.25), -2e-4 * sum(a^2).
    """

    reward_dim = 3
    frame_skip = 4
    n_sub = 4

    def __init__(self, max_episode_steps: int = 1000, device="cuda"):
        super().__init__(HOPPER, "mo-hopper-jx-v5", max_episode_steps, device)
        self.observation_space = Box(low=tuple(np.full(11, -np.inf)), high=tuple(np.full(11, np.inf)))

    def _obs(self, s: PlanarState) -> torch.Tensor:
        return torch.cat([s.q[:, 1:], torch.clamp(s.qd, -10.0, 10.0)], dim=1)

    def _mo_reward(self, s, a, vx):
        height = 10.0 * (s.q[:, 1] - 1.25)
        energy = -2e-4 * torch.sum(torch.square(a), dim=1)
        return torch.stack([vx, height, energy], dim=1)

    def _terminated(self, s: PlanarState) -> torch.Tensor:
        state_tail = torch.cat([s.q[:, 2:], s.qd], dim=1)
        healthy = (s.q[:, 1] > 0.7) & (torch.abs(s.q[:, 2]) < 0.2) & torch.all(torch.abs(state_tail) < 100.0, dim=1)
        return ~healthy


class MOHalfCheetahJX(PlanarMOEnv):
    """mo-halfcheetah (2 objectives; HalfCheetah-v5 physics).

    Observation = [qpos[1:], qvel] (17,), actions 6, no termination.
    Rewards: forward velocity, -0.1 * sum(a^2).  Stiff leg springs need a
    finer integration dt: 4 substeps per 0.01 s MuJoCo step x frame_skip 5 =
    20 substeps per control step.
    """

    reward_dim = 2
    frame_skip = 5
    n_sub = 20

    def __init__(self, max_episode_steps: int = 1000, device="cuda"):
        super().__init__(HALF_CHEETAH, "mo-halfcheetah-jx-v5", max_episode_steps, device)
        self.observation_space = Box(low=tuple(np.full(17, -np.inf)), high=tuple(np.full(17, np.inf)))

    def _obs(self, s: PlanarState) -> torch.Tensor:
        return torch.cat([s.q[:, 1:], s.qd], dim=1)

    def _mo_reward(self, s, a, vx):
        energy = -0.1 * torch.sum(torch.square(a), dim=1)
        return torch.stack([vx, energy], dim=1)

    def _terminated(self, s: PlanarState) -> torch.Tensor:
        return torch.zeros(s.q.shape[0], dtype=torch.bool, device=s.q.device)
