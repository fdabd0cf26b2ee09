"""Rendering and GIF export (counterpart of reference common/utils.py:50-68).

PyTorch port of ``morl_baselines_tpu/utils/render.py``.  The batched envs
have no render loop, so an env may implement ``render_frame(state) ->
(H, W, 3) uint8`` (host numpy, for visualization only) on a one-env state;
``rollout_frames`` steps one env collecting frames, and ``make_gif`` writes
them with PIL.  PIL is imported by ``make_gif`` alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List

import numpy as np
import torch


def make_gif(frames: List[np.ndarray], path: str | Path, fps: int = 15) -> Path:
    """Write a list of (H, W, 3) uint8 frames as an animated GIF."""
    from PIL import Image

    if not frames:
        raise ValueError("make_gif needs at least one frame")
    path = Path(path)
    if path.suffix != ".gif":
        path = path.with_suffix(".gif")
    path.parent.mkdir(parents=True, exist_ok=True)
    imgs = [Image.fromarray(np.asarray(f, dtype=np.uint8)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return path


@torch.no_grad()
def rollout_frames(env, act: Callable, gen: torch.Generator, max_steps: int = 500) -> List[np.ndarray]:
    """One episode of one env, a frame of ``env.render_frame`` per state.

    ``act(obs (1, obs_dim), gen) -> action (1, ...)``.  Slow by design (one
    host read a frame); use only for visualization.
    """
    if not hasattr(env, "render_frame"):
        raise NotImplementedError(f"{env.name} does not implement render_frame")
    state, obs = env.reset(1, gen)
    frames = [env.render_frame(state)]
    for _ in range(max_steps):
        out = env.step(state, act(obs, gen), env.sample_noise(1, gen))
        state, obs = out.state, out.obs
        frames.append(env.render_frame(state))
        if bool(out.terminated[0]) or bool(out.truncated[0]):
            break
    return frames
