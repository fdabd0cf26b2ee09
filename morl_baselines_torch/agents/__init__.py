"""Algorithm suite (ported so far: Envelope)."""

from .base import MOAgentBase
from .envelope import Envelope, EnvelopeConfig, EnvelopeState

__all__ = ["Envelope", "EnvelopeConfig", "EnvelopeState", "MOAgentBase"]
