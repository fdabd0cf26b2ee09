"""Algorithm suite (ported so far: Envelope, GPI-LS, GPI-PD, continuous GPI-LS and GPI-PD, MOPPO, PGMORL,
continuous and discrete MOSAC, MORL/D, MO-Q-Learning, MPMOQL, PQL, EUPG, PCN, LCN, CAPQL, NL-MOPPO and IPRO)."""

from .base import MOAgentBase
from .capql import CAPQL, CAPQLConfig, CAPQLState, sample_angle_weights
from .envelope import Envelope, EnvelopeConfig, EnvelopeState
from .eupg import EUPG, EUPGConfig, PolicyNet
from .gpils import GPILS, GPILSConfig, GPILSState
from .gpils_continuous import GPILSContinuous, GPILSContinuousConfig, GPILSContState
from .gpipd import GPIPD, GPIPDConfig, GPIPDState
from .gpipd_continuous import GPIPDContinuous, GPIPDContinuousConfig, GPIPDContState
from .ipro import IPRO, IPRO2D, IPROConfig
from .lcn import LCN, LCNConfig
from .moppo import MOPPO, MOPPOConfig, MOPPONet, MOPPOState
from .moql import MOQLearning, MOQLearningConfig
from .morld import MORLD, MORLDConfig
from .mosac import MOSAC, MOSACConfig, MOSACDiscrete, MOSACState
from .mpmoql import MPMOQLConfig, MPMOQLearning
from .nlmoppo import NLMOPPO, NLAgentNet, NLMOPPOConfig, NLMOPPOState
from .pcn import PCN, PCNConfig, PCNModel, PCNState
from .pgmorl import PGMORL, PGMORLConfig
from .pql import PQL, PQLConfig

__all__ = [
    "CAPQL",
    "CAPQLConfig",
    "CAPQLState",
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
    "IPRO",
    "IPRO2D",
    "IPROConfig",
    "LCN",
    "LCNConfig",
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
    "MOSACDiscrete",
    "MOSACConfig",
    "MOSACState",
    "MPMOQLConfig",
    "MPMOQLearning",
    "NLAgentNet",
    "NLMOPPO",
    "NLMOPPOConfig",
    "NLMOPPOState",
    "PCN",
    "PCNConfig",
    "PCNModel",
    "PCNState",
    "PGMORL",
    "PGMORLConfig",
    "PQL",
    "PQLConfig",
    "PolicyNet",
    "sample_angle_weights",
]
