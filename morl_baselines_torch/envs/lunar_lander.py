"""MO Lunar Lander (discrete + continuous) — batched torch rigid-body dynamics.

PyTorch port of ``morl_baselines_tpu/envs/lunar_lander.py``, the counterpart
of MO-Gymnasium's ``mo-lunar-lander-v3`` / ``mo-lunar-lander-continuous-v3``
(the reference's MORL/D showcase env, reference examples/morld_lunar_lander.py).
The 4-objective reward decomposes the classic scalar LunarLander reward into

    r = [ landed (+100 stable rest / -100 crash, else 0),
          shaped reward (potential difference of distance/speed/tilt/contacts),
          main-engine fuel  (-0.30 * m_power),
          side-engine fuel  (-0.03 * s_power) ]

The dynamics are the JAX package's branch-free planar rigid body in place of
Box2D: engine impulses, then ``SUBSTEPS`` explicit substeps with
spring-damper leg contacts on flat terrain at helipad height.  All N landers
step in one batched call; each substep is a few dozen elementwise ops on
(N,) and (N, 2) tensors (both legs on a trailing axis).  The randomness is
explicit: ``reset`` draws the (n, 2) initial force and ``sample_noise`` the
(n, 2) engine dispersion of a step, uniform in [-1, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import Box, Discrete, MOEnv, StepOut

# Box2D-world constants of the upstream env (pixels / SCALE = meters), the JAX package's values.
FPS = 50.0
SCALE = 30.0
W = 600.0 / SCALE  # world width  (20 m)
H = 400.0 / SCALE  # world height (13.33 m)
HELIPAD_Y = H / 4.0
MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
SIDE_ENGINE_HEIGHT = 14.0 / SCALE
SIDE_ENGINE_AWAY = 12.0 / SCALE
LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
INITIAL_RANDOM = 1000.0
GRAVITY = -10.0

# Rigid-body constants of the lander polygon, leg tips in the body frame, penalty contact
MASS = 4.96
INERTIA = 0.84
DT = 1.0 / FPS
SUBSTEPS = 8
LEG_TIP_X = LEG_AWAY + 0.25
LEG_TIP_Y = -(LEG_DOWN + 0.45)
BODY_BOTTOM = -10.0 / SCALE
CONTACT_K = 1500.0
CONTACT_C = 120.0
FRICTION_C = 40.0
FRICTION_MU = 1.5


class LLState(NamedTuple):
    x: torch.Tensor  # (N,)
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    angle: torch.Tensor
    omega: torch.Tensor
    prev_shaping: torch.Tensor
    t: torch.Tensor  # (N,) int32


def _leg_contacts(y, angle):
    """Ground-penetration depth of each leg tip (flat terrain at HELIPAD_Y); > 0 means penetrating."""
    c, s = torch.cos(angle), torch.sin(angle)
    return tuple(HELIPAD_Y - (y + s * (sx * LEG_TIP_X) + c * LEG_TIP_Y) for sx in (-1.0, 1.0))


class _LunarLanderBase(MOEnv):
    reward_dim = 4

    def __init__(self, max_episode_steps: int = 1000):
        self.max_episode_steps = max_episode_steps
        self._consts: dict[torch.device, torch.Tensor] = {}
        self.observation_space = Box(
            low=(-2.5, -2.5, -10.0, -10.0, -6.2831855, -10.0, 0.0, 0.0),
            high=(2.5, 2.5, 10.0, 10.0, 6.2831855, 10.0, 1.0, 1.0),
        )

    def _obs(self, s: LLState) -> torch.Tensor:
        d_l, d_r = _leg_contacts(s.y, s.angle)
        return torch.stack(
            [
                (s.x - W / 2.0) / (W / 2.0),
                (s.y - (HELIPAD_Y + LEG_DOWN)) / (H / 2.0),
                s.vx * (W / 2.0) / FPS,
                s.vy * (H / 2.0) / FPS,
                s.angle,
                20.0 * s.omega / FPS,
                (d_l > 0.0).to(torch.float32),
                (d_r > 0.0).to(torch.float32),
            ],
            dim=-1,
        )

    @staticmethod
    def _shaping(obs: torch.Tensor) -> torch.Tensor:
        o = obs.unbind(-1)
        return (
            -100.0 * torch.sqrt(o[0] * o[0] + o[1] * o[1])
            - 100.0 * torch.sqrt(o[2] * o[2] + o[3] * o[3])
            - 100.0 * torch.abs(o[4])
            + 10.0 * o[6]
            + 10.0 * o[7]
        )

    def initial_state(self, force: torch.Tensor):
        """(state, obs) of landers spawned at the top centre with a velocity
        from the (n, 2) initial force, applied for one world step (dv = F dt / m)."""
        n, dev = force.shape[0], force.device
        zero = torch.zeros((n,), device=dev)
        s = LLState(
            x=torch.full((n,), W / 2.0, device=dev),
            y=torch.full((n,), H, device=dev),  # upstream spawns at initial_y = VIEWPORT_H / SCALE
            vx=force[:, 0] * DT / MASS,
            vy=force[:, 1] * DT / MASS,
            angle=zero,
            omega=zero.clone(),
            prev_shaping=zero.clone(),
            t=torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        obs = self._obs(s)
        return s._replace(prev_shaping=self._shaping(obs)), obs

    def reset(self, n: int, gen: torch.Generator):
        force = (torch.rand((n, 2), generator=gen, device=gen.device) * 2.0 - 1.0) * INITIAL_RANDOM
        return self.initial_state(force)

    def sample_noise(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """(n, 2) uniforms in [-1, 1]: the engine dispersion of one step (the JAX step's ``kd`` times SCALE)."""
        return torch.rand((n, 2), generator=gen, device=gen.device) * 2.0 - 1.0

    def _leg_bx(self, device: torch.device) -> torch.Tensor:
        """The legs' body-frame x, (2,), on ``device``, cached."""
        if device not in self._consts:
            self._consts[device] = torch.tensor([-LEG_TIP_X, LEG_TIP_X], device=device)
        return self._consts[device]

    def _step_physics(self, state: LLState, m_power, s_dir, s_power, noise) -> LLState:
        """One env step: engine impulses, then SUBSTEPS of contact integration."""
        kd0, kd1 = (noise / SCALE).unbind(-1)
        c, s = torch.cos(state.angle), torch.sin(state.angle)
        # body-frame "up" axis in world coords: tip = (s, c); lateral: (-c, s)
        tip_x, tip_y, side_x, side_y = s, c, -c, s

        # main engine: impulse opposite the nozzle offset, applied off-centre
        ox = tip_x * (4.0 / SCALE + 2.0 * kd0) + side_x * kd1
        oy = -tip_y * (4.0 / SCALE + 2.0 * kd0) - side_y * kd1
        imp_mx = -ox * MAIN_ENGINE_POWER * m_power
        imp_my = -oy * MAIN_ENGINE_POWER * m_power
        tau_m = ox * imp_my - oy * imp_mx

        # side engine: impulse at the side nozzle, SIDE_ENGINE_HEIGHT up
        sox = tip_x * kd0 + side_x * (3.0 * kd1 + s_dir * SIDE_ENGINE_AWAY)
        soy = -tip_y * kd0 - side_y * (3.0 * kd1 + s_dir * SIDE_ENGINE_AWAY)
        imp_sx = -sox * SIDE_ENGINE_POWER * s_power
        imp_sy = -soy * SIDE_ENGINE_POWER * s_power
        rx = sox - tip_x * 17.0 / SCALE
        ry = soy + tip_y * SIDE_ENGINE_HEIGHT
        tau_s = rx * imp_sy - ry * imp_sx

        vx = state.vx + (imp_mx + imp_sx) / MASS
        vy = state.vy + (imp_my + imp_sy) / MASS
        omega = state.omega + (tau_m + tau_s) / INERTIA
        x, y, angle = state.x, state.y, state.angle

        h = DT / SUBSTEPS
        leg_bx = self._leg_bx(x.device)  # both legs on a trailing axis of 2
        for _ in range(SUBSTEPS):
            # spring-damper contacts of both legs, branch-free; viscous friction with a Coulomb cap
            ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
            rwx = ca * leg_bx - sa * LEG_TIP_Y
            rwy = sa * leg_bx + ca * LEG_TIP_Y
            pen = torch.clamp(HELIPAD_Y - (y[:, None] + rwy), min=0.0)
            touching = (pen > 0.0).to(torch.float32)
            tip_vy = vy[:, None] + omega[:, None] * rwx
            tip_vx = vx[:, None] - omega[:, None] * rwy
            fn = CONTACT_K * pen - CONTACT_C * tip_vy * touching
            fn = torch.clamp(fn, min=0.0) * touching
            ft = torch.minimum(torch.maximum(-FRICTION_C * tip_vx, -FRICTION_MU * fn), FRICTION_MU * fn)
            fx_c, fy_c, tau_c = ft.sum(-1), fn.sum(-1), (rwx * fn - rwy * ft).sum(-1)
            vx = vx + h * fx_c / MASS
            vy = vy + h * (GRAVITY + fy_c / MASS)
            omega = omega + h * tau_c / INERTIA
            omega = omega * (1.0 - 0.05 * h)  # Box2D angular damping analog
            x, y, angle = x + h * vx, y + h * vy, angle + h * omega
        return LLState(x, y, vx, vy, angle, omega, state.prev_shaping, state.t + 1)

    def _finish(self, state: LLState, m_power, s_power) -> StepOut:
        obs = self._obs(state)
        shaping = self._shaping(obs)
        shaped = shaping - state.prev_shaping
        state = state._replace(prev_shaping=shaping)

        # crash: body bottom under the terrain, out of the viewport, or a leg driven deep into the ground
        bottom_y = state.y + torch.cos(state.angle) * BODY_BOTTOM
        d_l, d_r = _leg_contacts(state.y, state.angle)
        crashed = (bottom_y < HELIPAD_Y - 0.02) | (torch.abs(obs[:, 0]) >= 1.0) | (torch.maximum(d_l, d_r) > 0.15)
        # landed: at rest with both legs down
        speed = torch.sqrt(state.vx * state.vx + state.vy * state.vy)
        landed = (obs[:, 6] > 0.0) & (obs[:, 7] > 0.0) & (speed < 0.05) & (torch.abs(state.omega) < 0.05) & ~crashed
        terminated = crashed | landed
        # the terminal step's reward is replaced by +-100, so its shaping and fuel are zeroed
        reward = torch.stack(
            [
                torch.where(crashed, -100.0, torch.where(landed, 100.0, 0.0)),
                torch.where(terminated, 0.0, shaped),
                torch.where(terminated, 0.0, -0.30 * m_power),
                torch.where(terminated, 0.0, -0.03 * s_power),
            ],
            dim=-1,
        )
        return StepOut(state, obs, reward, terminated, state.t >= self.max_episode_steps)

    def render_frame(self, state: LLState, width: int = 400, height: int = 267) -> np.ndarray:
        return _render_lander(state, width, height)


class MOLunarLander(_LunarLanderBase):
    """Discrete actions: 0 noop, 1 left engine, 2 main, 3 right."""

    name = "mo-lunar-lander-v3"

    def __init__(self, max_episode_steps: int = 1000):
        super().__init__(max_episode_steps)
        self.action_space = Discrete(4)

    def step(self, state: LLState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        action = action.reshape(-1)
        m_power = (action == 2).to(torch.float32)
        s_dir = torch.where(action == 1, -1.0, torch.where(action == 3, 1.0, 0.0))
        s_power = (s_dir != 0.0).to(torch.float32)
        state = self._step_physics(state, m_power, s_dir, s_power, noise)
        return self._finish(state, m_power, s_power)


class MOLunarLanderContinuous(_LunarLanderBase):
    """Continuous 2-D action: [main throttle, lateral thrust], both in [-1, 1]."""

    name = "mo-lunar-lander-continuous-v3"

    def __init__(self, max_episode_steps: int = 1000):
        super().__init__(max_episode_steps)
        self.action_space = Box(low=(-1.0, -1.0), high=(1.0, 1.0))

    def step(self, state: LLState, action: torch.Tensor, noise: torch.Tensor | None = None) -> StepOut:
        a0, a1 = torch.clamp(action.to(torch.float32).reshape(-1, 2), -1.0, 1.0).unbind(-1)
        # upstream throttle law: main fires above 0 at 50-100% power, side when |lateral| > 0.5
        m_power = torch.where(a0 > 0.0, torch.clamp(a0, 0.0, 1.0) * 0.5 + 0.5, 0.0)
        side_on = torch.abs(a1) > 0.5
        s_dir = torch.sign(a1) * side_on
        s_power = torch.where(side_on, torch.clamp(torch.abs(a1), 0.5, 1.0), 0.0)
        state = self._step_physics(state, m_power, s_dir, s_power, noise)
        return self._finish(state, m_power, s_power)


def lander_heuristic(obs: torch.Tensor) -> torch.Tensor:
    """The classic lunar-lander PD controller over a batch of obs (n, 8):
    discrete actions (n,), int64 (the JAX package's test heuristic)."""
    x, y, vx, vy, ang, vang, l1, l2 = obs.unbind(-1)
    ang_targ = torch.clamp(x * 0.5 + vx * 1.0, -0.4, 0.4)
    ang_todo = (ang_targ - ang) * 0.5 - vang * 1.0
    hover_todo = (0.55 * torch.abs(x) - y) * 0.5 - vy * 0.5
    contact = (l1 > 0) | (l2 > 0)
    ang_todo = torch.where(contact, 0.0, ang_todo)
    hover_todo = torch.where(contact, -vy * 0.5, hover_todo)
    side = torch.where(ang_todo < -0.05, 3, torch.where(ang_todo > 0.05, 1, 0))
    return torch.where((hover_todo > torch.abs(ang_todo)) & (hover_todo > 0.05), 2, side).long()


def _render_lander(state: LLState, width: int = 400, height: int = 267) -> np.ndarray:
    """(H, W, 3) uint8 frame of a one-env ``state`` (host numpy, visualization only)."""
    img = np.zeros((height, width, 3), dtype=np.uint8)
    img[:] = (10, 10, 30)  # sky
    sx, sy = width / W, height / H

    def to_px(wx, wy):
        return int(wx * sx), int(height - 1 - wy * sy)

    gy = to_px(0.0, HELIPAD_Y)[1]
    img[gy:, :] = (120, 110, 100)  # terrain
    x, y = float(state.x.reshape(())), float(state.y.reshape(()))
    ang = float(state.angle.reshape(()))
    c, s = np.cos(ang), np.sin(ang)
    # lander body quad + leg tips in world coords
    body = [(-0.55, 0.55), (0.55, 0.55), (0.55, BODY_BOTTOM), (-0.55, BODY_BOTTOM)]
    pts = [(x + c * bx - s * by, y + s * bx + c * by) for bx, by in body]
    xs = [to_px(px, py)[0] for px, py in pts]
    ys = [to_px(px, py)[1] for px, py in pts]
    x0, x1 = max(0, min(xs)), min(width - 1, max(xs))
    y0, y1 = max(0, min(ys)), min(height - 1, max(ys))
    if x0 <= x1 and y0 <= y1:
        img[y0 : y1 + 1, x0 : x1 + 1] = (200, 200, 220)
    for lsx in (-1.0, 1.0):
        lx = x + c * lsx * LEG_TIP_X - s * LEG_TIP_Y
        ly = y + s * lsx * LEG_TIP_X + c * LEG_TIP_Y
        px, py = to_px(lx, ly)
        if 0 <= px < width - 2 and 0 <= py < height - 2:
            img[py : py + 3, px : px + 3] = (220, 120, 40)
    return img
