"""Episodic replay for PCN/LCN — fixed-capacity episodes ranked for commands.

PyTorch port of ``morl_baselines_tpu/replay/episodic.py`` (reference
multi_policy/pcn/pcn.py: the episode heap :324-349 and ``_nlargest``
:250-279).  Variable-length episodes are (max_episodes, max_len, ...)
tensors with a length vector; ranking and eviction are a top-k over a score
computed as the reference's heap key: non-dominated episodes first, then the
negative distance of each return to the non-dominated set, with a crowding
tie-breaker.

The fill size is a host integer, so adding never waits on the device.
Top-k is a stable descending sort, so tied scores keep the lower row first,
as ``lax.top_k`` orders them (``torch.topk`` promises no order among ties,
and the non-dominated episodes' scores tie in float32 whenever their
crowding terms fall below an ulp of 1e6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.pareto import lorenz_vector, non_dominated_mask


class EpisodeBatch(NamedTuple):
    obs: torch.Tensor  # (E, T, obs_dim)
    action: torch.Tensor  # (E, T) or (E, T, A)
    reward: torch.Tensor  # (E, T, d)
    length: torch.Tensor  # (E,) int32
    vec_return: torch.Tensor  # (E, d) discounted return of the episode
    horizon: torch.Tensor  # (E,) float episode length (PCN's desired-horizon target)


class EpisodicBuffer:
    def __init__(self, data: EpisodeBatch, size: int = 0):
        self.data = data
        self.size = size  # valid episodes, a host integer

    @property
    def capacity(self) -> int:
        return self.data.obs.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.obs.shape[1]

    @staticmethod
    def create(
        max_episodes: int,
        max_len: int,
        obs_dim: int,
        reward_dim: int,
        action_shape: tuple = (),
        action_dtype=torch.int64,
        device="cuda",
    ) -> "EpisodicBuffer":
        data = EpisodeBatch(
            obs=torch.zeros((max_episodes, max_len, obs_dim), device=device),
            action=torch.zeros((max_episodes, max_len, *action_shape), dtype=action_dtype, device=device),
            reward=torch.zeros((max_episodes, max_len, reward_dim), device=device),
            length=torch.zeros((max_episodes,), dtype=torch.int32, device=device),
            vec_return=torch.full((max_episodes, reward_dim), -torch.inf, device=device),
            horizon=torch.zeros((max_episodes,), device=device),
        )
        return EpisodicBuffer(data)

    def valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.data.obs.device) < self.size

    def add_episodes(self, eps: EpisodeBatch, lorenz_lambda: float | None = None) -> "EpisodicBuffer":
        """Append episodes, then keep the ``capacity`` best by PCN's ranking, in place.

        With ``lorenz_lambda`` the ranking compares (lambda-)Lorenz vectors
        of the returns (LCN, reference lcn.py:226-237).
        """
        cat = EpisodeBatch(*(torch.cat([a, b.to(a.dtype)], dim=0) for a, b in zip(self.data, eps)))
        n_new = eps.vec_return.shape[0]
        valid = torch.cat([self.valid(), torch.ones((n_new,), dtype=torch.bool, device=self.data.obs.device)])
        rank_vals = cat.vec_return
        if lorenz_lambda is not None:
            rank_vals = torch.where(valid[:, None], lorenz_vector(cat.vec_return, lorenz_lambda), -torch.inf)
        score = _pcn_keep_score(rank_vals, valid)
        top = _top_k(torch.where(valid, score, -torch.inf), self.capacity)
        self.data = EpisodeBatch(*(x[top] for x in cat))
        self.size = min(self.size + n_new, self.capacity)
        return self

    def draw_steps(self, gen: torch.Generator, batch_size: int):
        """(episode, t) pairs uniform over the valid steps: e uniform over the
        episodes, t = floor(u * length) clipped to [0, max_len - 1]."""
        dev = self.data.obs.device
        e = torch.randint(0, max(self.size, 1), (batch_size,), generator=gen, device=gen.device).to(dev)
        u = torch.rand((batch_size,), generator=gen, device=gen.device).to(dev)
        t = (u * self.data.length[e].to(torch.float32)).to(torch.int64)
        return e, torch.clamp(t, 0, self.max_len - 1)

    def steps_at(self, e: torch.Tensor, t: torch.Tensor, gamma: float = 1.0):
        """obs, action, desired return (the discounted reward-to-go from t over
        the episode's steps t <= k < length) and desired horizon (length - t):
        the tuple PCN trains on (reference pcn.py:202-240)."""
        lengths = self.data.length[e]
        ks = torch.arange(self.max_len, device=e.device)[None, :]
        mask = (ks >= t[:, None]) & (ks < lengths[:, None])
        disc = torch.where(mask, torch.pow(gamma, (ks - t[:, None]).to(torch.float32)), 0.0)
        rtg = torch.einsum("btd,bt->bd", self.data.reward[e], disc)
        horizon = (lengths - t).to(torch.float32)
        return self.data.obs[e, t], self.data.action[e, t], rtg, horizon

    def sample_steps(self, gen: torch.Generator, batch_size: int, gamma: float = 1.0):
        return self.steps_at(*self.draw_steps(gen, batch_size), gamma)

    def top_returns(self, k: int):
        """(returns, horizons, valid) of the k best episodes, for command selection."""
        valid = self.valid()
        score = _pcn_keep_score(self.data.vec_return, valid)
        top = _top_k(torch.where(valid, score, -torch.inf), k)
        return self.data.vec_return[top], self.data.horizon[top], valid[top]


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties lower index first (``lax.top_k``'s order)."""
    return torch.argsort(score, descending=True, stable=True)[:k]


def _pcn_keep_score(returns: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Higher = more worth keeping: ``nd * 1e6 - dist + 1e-3 * crowd``, where
    dist is the distance to the nearest non-dominated return (0 for those
    themselves, 1e9 where none is finite)."""
    nd = non_dominated_mask(returns, valid)
    pts = torch.where(valid[:, None], returns, -torch.inf)
    nd_pts = torch.where(nd[:, None], returns, torch.inf)
    d2 = torch.sum((pts[:, None, :] - nd_pts[None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(torch.amin(torch.where(nd[None, :], d2, torch.inf), dim=-1))
    dist = torch.where(torch.isfinite(dist), dist, 1e9)
    crowd = crowding_distance(returns, valid)
    return nd.to(torch.float32) * 1e6 - dist + 1e-3 * crowd


def crowding_distance(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NSGA-II crowding distance (reference pcn.py crowding_distance): per
    objective, the gap between each row's two neighbours in the sorted order
    over the objective's span; the ends get 1e9.  The sorts are stable, as
    ``jnp.argsort``, so tied rows keep their order."""
    d = points.shape[1]
    big = 1e9
    pts = torch.where(valid[:, None], points, big)
    order = torch.argsort(pts, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True)
    srt = torch.gather(pts, 0, order)
    span = torch.clamp(srt[-1] - srt[0], min=1e-9)
    edge = torch.full((1, d), big, device=points.device)
    gaps = torch.cat([edge, srt[2:] - srt[:-2], edge], dim=0) / span
    crowd = torch.gather(gaps, 0, ranks)
    return torch.where(valid, torch.sum(torch.clamp(crowd, max=big), dim=-1), 0.0)
