"""Algorithm suite (ported so far: Envelope, GPI-LS, GPI-PD, continuous GPI-LS and GPI-PD, MOPPO, PGMORL,
continuous MOSAC, MORL/D, MO-Q-Learning, MPMOQL, PQL and EUPG)."""

from .base import MOAgentBase
from .envelope import Envelope, EnvelopeConfig, EnvelopeState
from .eupg import EUPG, EUPGConfig, PolicyNet
from .gpils import GPILS, GPILSConfig, GPILSState
from .gpils_continuous import GPILSContinuous, GPILSContinuousConfig, GPILSContState
from .gpipd import GPIPD, GPIPDConfig, GPIPDState
from .gpipd_continuous import GPIPDContinuous, GPIPDContinuousConfig, GPIPDContState
from .moppo import MOPPO, MOPPOConfig, MOPPONet, MOPPOState
from .moql import MOQLearning, MOQLearningConfig
from .morld import MORLD, MORLDConfig
from .mosac import MOSAC, MOSACConfig, MOSACState
from .mpmoql import MPMOQLConfig, MPMOQLearning
from .pgmorl import PGMORL, PGMORLConfig
from .pql import PQL, PQLConfig

__all__ = [
    "EUPG",
    "EUPGConfig",
    "Envelope",
    "EnvelopeConfig",
    "EnvelopeState",
    "GPILS",
    "GPILSConfig",
    "GPILSContState",
    "GPILSContinuous",
    "GPILSContinuousConfig",
    "GPILSState",
    "GPIPD",
    "GPIPDConfig",
    "GPIPDContState",
    "GPIPDContinuous",
    "GPIPDContinuousConfig",
    "GPIPDState",
    "MOAgentBase",
    "MOPPO",
    "MOPPOConfig",
    "MOPPONet",
    "MOPPOState",
    "MOQLearning",
    "MOQLearningConfig",
    "MORLD",
    "MORLDConfig",
    "MOSAC",
    "MOSACConfig",
    "MOSACState",
    "MPMOQLConfig",
    "MPMOQLearning",
    "PGMORL",
    "PGMORLConfig",
    "PQL",
    "PQLConfig",
    "PolicyNet",
]
