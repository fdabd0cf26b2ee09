"""Algorithm suite (ported so far: Envelope, GPI-LS, GPI-PD)."""

from .base import MOAgentBase
from .envelope import Envelope, EnvelopeConfig, EnvelopeState
from .gpils import GPILS, GPILSConfig, GPILSState
from .gpipd import GPIPD, GPIPDConfig, GPIPDState

__all__ = [
    "Envelope",
    "EnvelopeConfig",
    "EnvelopeState",
    "GPILS",
    "GPILSConfig",
    "GPILSState",
    "GPIPD",
    "GPIPDConfig",
    "GPIPDState",
    "MOAgentBase",
]
