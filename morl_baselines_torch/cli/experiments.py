"""Algorithm registry and experiment helpers for the CLIs.

PyTorch port of ``morl_baselines_tpu/cli/experiments.py`` (reference
common/experiments.py:26-77: the ALGOS dict and the StoreDict argparse
action), plus ``make_env``, which hands the device to the envs that hold
their constants on one.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

from ..agents import (
    CAPQL,
    GPILS,
    GPIPD,
    IPRO,
    IPRO2D,
    LCN,
    MORLD,
    PCN,
    PGMORL,
    PQL,
    Envelope,
    GPILSContinuous,
    GPIPDContinuous,
    MPMOQLearning,
)
from ..envs.base import MOEnv
from ..envs.planar import MOHalfCheetahJX, MOHopperJX
from ..envs.registry import ENV_REGISTRY, ENVS_WITH_KNOWN_PARETO_FRONT, make

# name -> agent class (reference ALGOS, experiments.py:26-43)
ALGOS: Dict[str, Any] = {
    "pql": PQL,
    "gpi_pd_discrete": GPIPD,
    "gpi_ls_discrete": GPILS,
    "gpi_ls_continuous": GPILSContinuous,
    "gpi_pd_continuous": GPIPDContinuous,
    "envelope": Envelope,
    "pgmorl": PGMORL,
    "capql": CAPQL,
    "mpmoql": MPMOQLearning,
    "pcn": PCN,
    "lcn": LCN,
    "morld": MORLD,
    "ipro": IPRO,
    "ipro-2D": IPRO2D,
}

__all__ = ["ALGOS", "ENVS_WITH_KNOWN_PARETO_FRONT", "StoreDict", "make_env"]


def make_env(env_id: str, device, **kwargs) -> MOEnv:
    """``make(env_id, **kwargs)``; the planar envs keep their constants on ``device``."""
    if ENV_REGISTRY.get(env_id) in (MOHopperJX, MOHalfCheetahJX):
        return make(env_id, device=device, **kwargs)
    return make(env_id, **kwargs)


class StoreDict(argparse.Action):
    """Parse `key:value` pairs into a dict, eval-ing values (reference :55-77)."""

    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        self._nargs = nargs
        super().__init__(option_strings, dest, nargs=nargs, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        arg_dict = {}
        for arguments in values:
            key = arguments.split(":")[0]
            value = ":".join(arguments.split(":")[1:])
            arg_dict[key] = eval(value)  # noqa: S307 — same contract as the reference CLI
        setattr(namespace, self.dest, arg_dict)
