"""Physical constants of the planar hopper and halfcheetah.

The numbers are gymnasium's ``hopper.xml`` and ``half_cheetah.xml`` (the
MuJoCo models of Hopper-v5 and HalfCheetah-v5) projected onto the x-z plane
exactly as ``morl_baselines_tpu/envs/planar.py::_build_planar_model`` projects
them: per body its parent, frame origin, hinge anchor and axis sign, centre
of mass, mass and y-inertia; per DOF armature, damping, stiffness, spring
rest position and range; per actuator its gear and DOF; per contact sphere
(both ends of every capsule) its body, local centre, radius and friction.
Every array literal is float32-exact, so ``np.float32`` of it equals that
projection bit for bit.  They are carried here as numbers so that the port
needs neither ``mujoco`` nor ``gymnasium`` at run time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_INF = np.inf


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class PlanarModel(NamedTuple):
    """Static parameters of a planar kinematic chain (numpy float32 arrays)."""

    parent: tuple  # (nb,) -1 for the root
    body_pos: np.ndarray  # (nb, 2) frame origin in the parent frame
    jnt_pos: np.ndarray  # (nb, 2) hinge anchor in the body frame
    jnt_sign: np.ndarray  # (nb,) +1/-1: y-component of the hinge axis
    jnt_dof: tuple  # (nb,) index into q of the body's hinge
    ipos: np.ndarray  # (nb, 2) centre of mass in the body frame
    mass: np.ndarray  # (nb,)
    inertia: np.ndarray  # (nb,) Iyy about the centre of mass
    armature: np.ndarray  # (nq,)
    damping: np.ndarray  # (nq,)
    stiffness: np.ndarray  # (nq,)
    qpos_spring: np.ndarray  # (nq,)
    jnt_lo: np.ndarray  # (nq,) -inf where unlimited
    jnt_hi: np.ndarray  # (nq,)
    gear: np.ndarray  # (nu,)
    act_dof: tuple  # (nu,)
    cp_body: tuple  # (nc,) body of each contact sphere
    cp_local: np.ndarray  # (nc, 2) sphere centre in the body frame
    cp_radius: np.ndarray  # (nc,)
    cp_mu: np.ndarray  # (nc,)
    qpos0: np.ndarray  # (nq,)
    timestep: float  # MuJoCo's opt.timestep
    nq: int
    nu: int


HOPPER = PlanarModel(
    parent=(-1, 0, 1, 2),
    body_pos=_f32([[0.0, 1.25], [0.0, -0.2], [0.0, -0.7], [0.13, -0.35]]),
    jnt_pos=_f32([[0.0, 0.0], [0.0, 0.0], [0.0, 0.25], [-0.13, 0.1]]),
    jnt_sign=_f32([1.0, -1.0, -1.0, -1.0]),
    jnt_dof=(2, 3, 4, 5),
    ipos=_f32([[0.0, 0.0], [0.0, -0.225], [0.0, 0.0], [-0.065, 0.1]]),
    mass=_f32([3.6651914, 4.0578904, 2.7813568, 5.3155746]),
    inertia=_f32([0.069245934, 0.093298756, 0.07230254, 0.10352308]),
    armature=_f32([0.0, 0.0, 0.0, 1.0, 1.0, 1.0]),
    damping=_f32([0.0, 0.0, 0.0, 1.0, 1.0, 1.0]),
    stiffness=_f32([0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
    qpos_spring=_f32([0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
    jnt_lo=_f32([-_INF, -_INF, -_INF, -2.6179938, -2.6179938, -0.7853982]),
    jnt_hi=_f32([_INF, _INF, _INF, 0.0, 0.0, 0.7853982]),
    gear=_f32([200.0, 200.0, 200.0]),
    act_dof=(3, 4, 5),
    cp_body=(0, 0, 1, 1, 2, 2, 3, 3),
    cp_local=_f32(
        [[0.0, 0.2], [0.0, -0.2], [0.0, -5.551115e-17], [0.0, -0.45], [0.0, 0.25], [0.0, -0.25], [-0.26, 0.1], [0.13, 0.1]]
    ),
    cp_radius=_f32([0.05, 0.05, 0.05, 0.05, 0.04, 0.04, 0.06, 0.06]),
    cp_mu=_f32([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0]),
    qpos0=_f32([0.0, 1.25, 0.0, 0.0, 0.0, 0.0]),
    timestep=0.002,
    nq=6,
    nu=3,
)

HALF_CHEETAH = PlanarModel(
    parent=(-1, 0, 1, 2, 0, 4, 5),
    body_pos=_f32([[0.0, 0.7], [-0.5, 0.0], [0.16, -0.25], [-0.28, -0.14], [0.5, 0.0], [-0.14, -0.24], [0.13, -0.18]]),
    jnt_pos=_f32([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]),
    jnt_sign=_f32([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]),
    jnt_dof=(2, 3, 4, 5, 6, 7, 8),
    ipos=_f32(
        [[0.15238988, 0.025398312], [0.1, -0.13], [-0.14, -0.07], [0.03, -0.097], [-0.07, -0.12], [0.065, -0.09],
         [0.045, -0.07]]
    ),
    mass=_f32([6.2502093, 1.5435146, 1.5874476, 1.0953975, 1.4380753, 1.2008368, 0.8845188]),
    inertia=_f32([0.88565546, 0.01684434, 0.01826742, 0.006352423, 0.013739644, 0.008222109, 0.0035291095]),
    armature=_f32([0.0, 0.0, 0.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]),
    damping=_f32([0.0, 0.0, 0.0, 6.0, 4.5, 3.0, 4.5, 3.0, 1.5]),
    stiffness=_f32([0.0, 0.0, 0.0, 240.0, 180.0, 120.0, 180.0, 120.0, 60.0]),
    qpos_spring=_f32([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
    jnt_lo=_f32([-_INF, -_INF, -_INF, -0.52, -0.785, -0.4, -1.0, -1.2, -0.5]),
    jnt_hi=_f32([_INF, _INF, _INF, 1.05, 0.785, 0.785, 0.7, 0.87, 0.5]),
    gear=_f32([120.0, 90.0, 60.0, 120.0, 60.0, 30.0]),
    act_dof=(3, 4, 5, 6, 7, 8),
    cp_body=(0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6),
    cp_local=_f32(
        [[-0.5, 3.061617e-17], [0.5, -3.061617e-17], [0.7146493, 0.19672398], [0.48535067, 0.003276018],
         [0.18871939, -0.24469031], [0.011280606, -0.015309682], [-0.27446085, -0.13648516],
         [-0.005539139, -0.0035148377], [0.004927245, -0.0064055356], [0.055072755, -0.18759446],
         [-0.0039149416, -0.0045800493], [-0.13608506, -0.23541994], [0.0051478976, -0.0025144247],
         [0.1248521, -0.17748557], [0.005475027, -0.012226507], [0.084524974, -0.1277735]]
    ),
    cp_radius=_f32([0.046] * 16),
    cp_mu=_f32([0.4] * 16),
    qpos0=_f32([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
    timestep=0.01,
    nq=9,
    nu=6,
)  # fmt: skip
