"""Algorithm suite (ported so far: Envelope, GPI-LS, GPI-PD, and continuous GPI-LS and GPI-PD)."""

from .base import MOAgentBase
from .envelope import Envelope, EnvelopeConfig, EnvelopeState
from .gpils import GPILS, GPILSConfig, GPILSState
from .gpils_continuous import GPILSContinuous, GPILSContinuousConfig, GPILSContState
from .gpipd import GPIPD, GPIPDConfig, GPIPDState
from .gpipd_continuous import GPIPDContinuous, GPIPDContinuousConfig, GPIPDContState

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
]
