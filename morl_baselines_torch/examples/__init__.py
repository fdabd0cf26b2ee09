"""Runnable examples, one module per ``examples/*.py`` of the JAX package.

Each uses its JAX counterpart's config, env and budget, and runs as

    python -m morl_baselines_torch.examples.<stem> [--device cuda]

on the card by default; ``--device cpu`` runs it on the CPU.  Each module's
``main(argv)`` returns the trained agent.
"""

from __future__ import annotations

import argparse


def parse_device(argv=None, doc: str | None = None) -> str:
    """The ``--device`` of an example's command line (default ``cuda``)."""
    parser = argparse.ArgumentParser(description=doc)
    parser.add_argument("--device", default="cuda", help="torch device; cpu only when asked for")
    return parser.parse_args(argv).device
