"""Algorithm suite (ported so far: Envelope, GPI-LS, GPI-PD, continuous GPI-LS and GPI-PD, MOPPO, PGMORL, continuous MOSAC and MORL/D)."""

from .base import MOAgentBase
from .envelope import Envelope, EnvelopeConfig, EnvelopeState
from .gpils import GPILS, GPILSConfig, GPILSState
from .gpils_continuous import GPILSContinuous, GPILSContinuousConfig, GPILSContState
from .gpipd import GPIPD, GPIPDConfig, GPIPDState
from .gpipd_continuous import GPIPDContinuous, GPIPDContinuousConfig, GPIPDContState
from .moppo import MOPPO, MOPPOConfig, MOPPONet, MOPPOState
from .morld import MORLD, MORLDConfig
from .mosac import MOSAC, MOSACConfig, MOSACState
from .pgmorl import PGMORL, PGMORLConfig

__all__ = [
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
    "MORLD",
    "MORLDConfig",
    "MOSAC",
    "MOSACConfig",
    "MOSACState",
    "PGMORL",
    "PGMORLConfig",
]
