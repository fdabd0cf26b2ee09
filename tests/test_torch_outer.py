"""The port's LinearSupport (OLS / GPI-LS corner weights) against the JAX package's.

Mirrors tests/test_outer.py on the port, and runs both packages through the
same scripted sequence of ``next_weight`` / ``add_solution`` calls in both
modes, holding corner weights, priorities, CCS, weight support and queue
identical (the module is host numpy and scipy in both).
"""

import random

import numpy as np
import pytest
import torch

from morl_baselines_torch.outer import LinearSupport
from morl_baselines_tpu.outer import LinearSupport as JLinearSupport

torch.set_num_threads(1)

KNOWN = np.array([[10.0, 0.0], [8.0, 6.0], [4.0, 9.0], [0.0, 10.0], [3.0, 3.0]])
# (3,3) is convex-dominated and must not end up in the CCS


def oracle(w):
    return KNOWN[np.argmax(KNOWN @ w)]


def test_ols_recovers_ccs():
    ols = LinearSupport(num_objectives=2, epsilon=1e-6)
    for _ in range(20):
        w = ols.next_weight("ols")
        if w is None:
            break
        ols.add_solution(oracle(w), w)
    ccs = np.array(sorted(map(tuple, ols.ccs)))
    expect = np.array(sorted(map(tuple, KNOWN[:4])))
    np.testing.assert_allclose(ccs, expect, atol=1e-6)
    assert ols.ended()


def test_corner_weights_geometry():
    ls = LinearSupport(num_objectives=2)
    ls.visited_weights = [np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    ls.ccs = [np.array([10.0, 0.0]), np.array([0.0, 10.0])]
    ls.weight_support = list(ls.visited_weights)
    corners = ls.compute_corner_weights()
    assert any(np.allclose(c, [0.5, 0.5], atol=1e-4) for c in corners)


def test_max_value_lp():
    ls = LinearSupport(num_objectives=2)
    ls.visited_weights = [np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    ls.ccs = [np.array([10.0, 0.0]), np.array([0.0, 10.0])]
    ls.weight_support = list(ls.visited_weights)
    assert ls.max_value_lp(np.array([0.5, 0.5])) == pytest.approx(10.0, abs=1e-5)


def test_gpi_ls_priority_uses_evaluator():
    ls = LinearSupport(num_objectives=2, epsilon=None)
    ls.add_solution(np.array([10.0, 0.0]), np.array([1.0, 0.0]))
    ls.add_solution(np.array([0.0, 10.0]), np.array([0.0, 1.0]))
    calls = {}

    def gpi_eval(ws):
        calls["ws"] = ws
        return np.tile(np.array([[6.0, 6.0]]), (len(ws), 1))

    w = ls.next_weight("gpi-ls", gpi_evaluator=gpi_eval)
    assert "ws" in calls
    np.testing.assert_allclose(w, [0.5, 0.5], atol=1e-4)


def test_dominated_solution_discarded():
    ls = LinearSupport(num_objectives=2)
    ls.add_solution(np.array([10.0, 10.0]), np.array([0.5, 0.5]))
    ls.add_solution(np.array([1.0, 1.0]), np.array([0.6, 0.4]))
    assert len(ls.ccs) == 1
    np.testing.assert_allclose(ls.ccs[0], [10.0, 10.0])


KNOWN3 = np.array(
    [[10.0, 0.0, 0.0], [0.0, 10.0, 0.0], [0.0, 0.0, 10.0], [6.0, 6.0, 0.0], [0.0, 5.0, 7.0], [4.0, 4.0, 4.0], [2.0, 2.0, 2.0]]
)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("d,algo", [(2, "ols"), (2, "gpi-ls"), (3, "ols"), (3, "gpi-ls")])
def test_linear_support_parity(d, algo):
    """Identical corner weights, priorities, CCS, weight support and queue at
    every step of the outer loop, given the same oracle and tie-shuffle rng."""
    known = KNOWN if d == 2 else KNOWN3
    eps = 0.0 if algo == "ols" else None
    port, ref = LinearSupport(d, epsilon=eps), JLinearSupport(d, epsilon=eps)
    rng_p, rng_r = random.Random(0), random.Random(0)
    # a GPI evaluator that is not the oracle: each corner gets a blend of the two best vectors
    evaluator = lambda ws: np.stack([0.9 * known[np.argmax(known @ w)] + 0.1 * known[np.argsort(known @ w)[-2]] for w in ws])  # noqa: E731
    steps = 0
    for _ in range(12):
        wp = port.next_weight(algo, gpi_evaluator=evaluator, rng=rng_p)
        wr = ref.next_weight(algo, gpi_evaluator=evaluator, rng=rng_r)
        assert (wp is None) == (wr is None)
        if wp is None:
            break
        np.testing.assert_array_equal(wp, wr)
        _same(port.compute_corner_weights() if port.ccs else [], ref.compute_corner_weights() if ref.ccs else [])
        assert [p for p, _ in port.queue] == [p for p, _ in ref.queue]
        _same(port.get_corner_weights(), ref.get_corner_weights())
        assert port.add_solution(known[np.argmax(known @ wp)], wp) == ref.add_solution(known[np.argmax(known @ wr)], wr)
        _same(port.ccs, ref.ccs)
        _same(port.get_weight_support(), ref.get_weight_support())
        steps += 1
    assert steps >= 3
    assert port.ended() == ref.ended()
