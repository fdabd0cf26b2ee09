"""Parity of the torch port's continuous actors and critics with the JAX package's.

Params and batch statistics come from the flax ``init`` (the statistics then
set to random values, ``steps`` before or past ``warmup_steps``) and are
carried across with ``load_flax_variables``; inputs are made with numpy from
a seed.  Tolerance: atol 1e-5 on every float32 output and statistic
(float32 sums in another order); integer step counters exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_torch.models import (
    BatchRenorm,
    ContinuousQNet,
    DeterministicActor,
    StabilizedActor,
    StabilizedQNet,
    load_flax_variables,
    to_flax_variables,
)
from morl_baselines_tpu.models import continuous as jcont
from morl_baselines_tpu.models.networks import BatchRenorm as JBatchRenorm
from morl_baselines_tpu.models.networks import ensemble as j_ensemble

torch.set_num_threads(1)
ATOL = 1e-5
OBS, ACT, D, H = 11, 3, 3, (32, 16)


def _inputs(seed, b=64):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, OBS)).astype(np.float32),
        rng.uniform(-1, 1, size=(b, ACT)).astype(np.float32),
        rng.dirichlet(np.ones(D), size=b).astype(np.float32),
    )


def _random_stats(stats, rng, steps):
    """The flax ``batch_stats`` tree with random means/variances and ``steps`` set."""
    def leaf(path, x):
        name = path[-1].key
        if name == "steps":
            return np.full(x.shape, steps, np.int32)
        if name == "mean":
            return rng.normal(scale=0.5, size=x.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, stats))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees(port, flax, atol=ATOL):
    flax = _np(flax)
    assert jax.tree.structure(port) == jax.tree.structure(flax)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(flax)):
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol)


def _pair(kind, members=2):
    if kind == "stabilized_q":
        jnet = j_ensemble(jcont.StabilizedQNet, members, reward_dim=D, hidden=H, dropout_rate=0.0)
        tnet = StabilizedQNet(OBS, ACT, D, H, dropout_rate=0.0, members=members)
    elif kind == "stabilized_actor":
        jnet, tnet = jcont.StabilizedActor(action_dim=ACT, hidden=H), StabilizedActor(OBS, D, ACT, H)
    elif kind == "deterministic_actor":
        jnet, tnet = jcont.DeterministicActor(action_dim=ACT, hidden=H), DeterministicActor(OBS, D, ACT, H)
    else:
        jnet = j_ensemble(jcont.ContinuousQNet, members, reward_dim=D, hidden=H)
        tnet = ContinuousQNet(OBS, ACT, D, H, members=members)
    return jnet, tnet


def _apply(kind, jnet, variables, obs, act, w, train):
    args = (obs, w) if "actor" in kind else (obs, act, w)
    if kind == "stabilized_q":
        args = args + (train, True)
    elif kind == "stabilized_actor":
        args = args + (train,)
    if train and "stabilized" in kind:
        return jnet.apply(variables, *args, mutable=["batch_stats"])
    return jnet.apply(variables, *args), None


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["stabilized_q", "stabilized_actor", "deterministic_actor", "continuous_q"])
def test_forward_parity(kind, train):
    """Every net in eval and train mode (BatchRenorm past warm-up, so r and d
    act); in train mode also the updated running statistics."""
    jnet, tnet = _pair(kind)
    obs, act, w = _inputs(1)
    jo, ja, jw = jnp.asarray(obs), jnp.asarray(act), jnp.asarray(w)
    variables = _np(jnet.init(jax.random.key(3), jo[:1], *(([jw[:1]]) if "actor" in kind else [ja[:1], jw[:1]])))
    if "batch_stats" in variables:
        variables["batch_stats"] = _random_stats(variables["batch_stats"], np.random.default_rng(4), 100_001)
    load_flax_variables(tnet, variables)
    want, mut = _apply(kind, jnet, variables, jo, ja, jw, train)
    targs = (obs, w) if "actor" in kind else (obs, act, w)
    got = tnet(*(torch.as_tensor(x) for x in targs), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    if mut is not None:
        _assert_trees(to_flax_variables(tnet)["batch_stats"], mut["batch_stats"])


@pytest.mark.parametrize("steps", [0, 100_000, 100_001])
def test_batch_renorm_update(steps):
    """The running-stat update and the output, before warm-up (plain batch
    norm: r = 1, d = 0), at the boundary (``steps > warmup_steps`` read
    before the increment) and after it; with an ensemble axis of 3."""
    rng = np.random.default_rng(steps)
    x = (3.0 * rng.normal(size=(3, 40, 8)) + 1.0).astype(np.float32)
    jbrn = JBatchRenorm(use_running_average=False)
    variables = _np(jax.vmap(lambda xx: jbrn.init(jax.random.key(0), xx))(jnp.asarray(x)))
    variables["batch_stats"] = _random_stats(variables["batch_stats"], rng, steps)
    variables["params"] = {"scale": rng.uniform(0.5, 1.5, (3, 8)).astype(np.float32), "bias": rng.normal(size=(3, 8)).astype(np.float32)}
    want, mut = jax.vmap(lambda v, xx: jbrn.apply(v, xx, mutable=["batch_stats"]))(variables, jnp.asarray(x))

    tbrn = BatchRenorm(8, members=3)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.brn = tbrn

        def flax_layout(self):
            return {"BatchRenorm_0": self.brn}

    holder = load_flax_variables(Holder(), {"params": {"BatchRenorm_0": variables["params"]},
                                            "batch_stats": {"BatchRenorm_0": variables["batch_stats"]}})
    xt = torch.tensor(x, requires_grad=True)
    got = tbrn(xt, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    _assert_trees(to_flax_variables(holder)["batch_stats"]["BatchRenorm_0"], mut["batch_stats"])
    # r and d carry no gradient: d(sum y)/dx is that of a plain batch norm's
    got.sum().backward()
    jgrad = jax.grad(lambda xx: jax.vmap(lambda v, a: jbrn.apply(v, a, mutable=["batch_stats"])[0])(variables, xx).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), atol=ATOL)
    # eval mode reads the running statistics and leaves them alone
    before = [b.clone() for b in tbrn.buffers()]
    ev = tbrn(torch.as_tensor(x))
    want_ev = jax.vmap(lambda v, xx: JBatchRenorm(use_running_average=True).apply(v, xx))(
        {"params": variables["params"], "batch_stats": _np(mut["batch_stats"])}, jnp.asarray(x)
    )
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(want_ev), atol=ATOL)
    assert all(torch.equal(a, b) for a, b in zip(before, tbrn.buffers()))


@pytest.mark.parametrize("kind", ["stabilized_q", "stabilized_actor", "deterministic_actor", "continuous_q"])
def test_carried_weights_round_trip(kind):
    """flax -> port -> flax gives back the same tree, bit for bit; the
    WeightNorm scales and the ensemble's per-critic statistics included."""
    jnet, tnet = _pair(kind, members=3)
    obs, act, w = (jnp.asarray(x[:1]) for x in _inputs(2))
    variables = _np(jnet.init(jax.random.key(5), obs, *(([w]) if "actor" in kind else [act, w])))
    if "batch_stats" in variables:
        variables["batch_stats"] = _random_stats(variables["batch_stats"], np.random.default_rng(6), 7)
    load_flax_variables(tnet, variables)
    back = to_flax_variables(tnet)
    if "batch_stats" not in variables:
        assert back["batch_stats"] == {}
        back = {"params": back["params"]}
    _assert_trees(back, variables, atol=0.0)
    with pytest.raises(ValueError):
        bad = _np(variables)
        bad["params"] = dict(bad["params"], extra={"kernel": np.zeros(1)})
        load_flax_variables(tnet, bad)
