"""Metric logging — reference-compatible names; stdout, JSONL and wandb sinks.

PyTorch port of ``morl_baselines_tpu/utils/logging.py``.  The metric keys and
the ``global_step`` step semantics are the reference's (reference
common/morl_algorithm.py:283-337, evaluation.py:147-277), so curves are
directly comparable.  wandb is optional: when it is not importable the logger
says so on stderr and keeps its stdout and JSONL sinks.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any


class MetricLogger:
    def __init__(
        self,
        project: str = "morl-baselines-torch",
        experiment: str = "run",
        jsonl_path: str | Path | None = None,
        use_wandb: bool = False,
        wandb_config: dict | None = None,
        stdout_every: int = 1,
        enabled: bool = True,
    ):
        self.project = project
        self.experiment = experiment
        self.enabled = enabled
        self.stdout_every = stdout_every
        self._n = 0
        self._jsonl = None
        self._wandb = None
        self._t0 = time.time()
        if not enabled:
            return
        if jsonl_path is not None:
            Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=experiment, config=wandb_config or {})
                wandb.define_metric("*", step_metric="global_step")
            except ImportError:
                print("[logger] wandb not available; falling back to stdout/jsonl", file=sys.stderr)

    def log(self, metrics: dict[str, Any], global_step: int) -> None:
        if not self.enabled:
            return
        payload = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        payload["global_step"] = int(global_step)
        self._n += 1
        if self._n % self.stdout_every == 0:
            keys = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in payload.items())
            print(f"[{time.time() - self._t0:8.1f}s] {keys}")
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(payload, step=int(global_step))

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


def reset_wandb_env() -> None:
    """Clear the per-run ``WANDB_*`` environment variables so a child sweep
    worker starts fresh (reference common/utils.py:110-123); the project,
    entity and API-key variables stay, so the worker still knows where to log."""
    import os

    keep = {"WANDB_PROJECT", "WANDB_ENTITY", "WANDB_API_KEY"}
    for k in [k for k in os.environ if k.startswith("WANDB_") and k not in keep]:
        del os.environ[k]
