"""The port's sharding layer (``morl_baselines_torch/parallel``) with 2 gloo
ranks on the CPU: mirrors of tests/test_parallel.py, whose cases run on the
JAX package's 8-device virtual CPU mesh.

The ranks are started once for the module (``parallel.launch``, a
``file://`` rendezvous under the test's temporary directory, so concurrent
runs never share one); each runs ``parallel.cases.run_cases`` and writes
what every case found, and each test below reads its case.  A rank that
finds unsynced replicas raises, which fails the launch.  Tolerances are the
JAX tests': MO-Q-Learning sharded against one process at rtol 1e-5 / atol
1e-6, GPI-LS, continuous GPI-LS and MORL/D at rtol 2e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from morl_baselines_torch.parallel import launch
from morl_baselines_torch.parallel.cases import run_cases

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    launch(run_cases, WORLD, f"file://{out}/rendezvous", "gloo", args=(str(out),))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _close(a, b, rtol, atol):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def test_mesh_and_shardings(ranks):
    for res in ranks:
        mesh = res["mesh"]
        assert mesh[(("data",), None)] == ((WORLD,), ("data",))
        assert mesh[(("pop", "data"), (1, WORLD))] == ((1, WORLD), ("pop", "data"))
        assert mesh[(("pop", "data"), (WORLD, 1))] == ((WORLD, 1), ("pop", "data"))
        assert mesh["errors"] == [f"n_devices={WORLD + 1} is not the world size {WORLD}",
                                  "shape required for multi-axis meshes"]


def test_sharded_envelope_segment(ranks):
    """16 envs over 2 ranks, 4 iterations: 8 rows a rank, global step 64,
    every replica's buffer holds all 64 transitions, params finite and synced."""
    for res in ranks:
        assert res["envelope"] == dict(local_rows=8, global_step=64, buffer_size=64, finite=True)


def test_sharded_vs_single_process_equivalence(ranks):
    for res in ranks:
        np.testing.assert_allclose(res["moql"]["single"], res["moql"]["sharded"], rtol=1e-5, atol=1e-6)


def test_sharded_gpils_segment_equivalence(ranks):
    for res in ranks:
        _close(res["gpils"]["single"], res["gpils"]["sharded"], 2e-4, 1e-5)


def test_sharded_gpils_continuous_segment(ranks):
    for res in ranks:
        single, sharded = res["gpils_continuous"]["single"], res["gpils_continuous"]["sharded"]
        _close(single["critic"], sharded["critic"], 2e-4, 1e-5)
        _close(single["stats"], sharded["stats"], 2e-4, 1e-5)
        assert sharded["actor_finite"]


def test_vectorized_morld_population_mesh(ranks):
    """MORL/D with its 4 members sharded over a 2-rank ``pop`` mesh: an
    archive, HV >= 0, the returned state gathered to all 4 members and
    finite, every rank's archive and weights alike, and the one-process run's."""
    for res in ranks:
        m = res["morld"]["sharded"]
        assert len(m["archive"]) >= 1 and m["hv"] >= 0.0 and m["leading"] == 4 and m["finite"]
        assert m["weights"].shape == (4, 2)
        single = res["morld"]["single"]
        _close([single["archive"], single["weights"], *single["actor"]], [m["archive"], m["weights"], *m["actor"]],
               2e-4, 1e-5)
    a, b = (res["morld"]["sharded"] for res in ranks)
    np.testing.assert_array_equal(a["archive"], b["archive"])
    np.testing.assert_array_equal(a["weights"], b["weights"])


def test_sharded_env_noise(ranks):
    """Every env with step noise, bare and under ``MOMaxAndSkipObservation``
    (noise stacked over sub-steps, the env axis second): 8 envs stepped and
    evaluated over 2 ranks, each drawing all 8 envs' noise and keeping its
    rows, gather bit for bit to the one-process run; episodes end, so the
    autoreset's draws are sliced too."""
    for res in ranks:
        assert set(res["noise"]) == {"resource-gathering-v0", "minecart-v0", "water-reservoir-v0", "mo-lunar-lander-v3",
                                     "max-and-skip(resource-gathering-v0)", "max-and-skip(mo-lunar-lander-v3)"}
        for name, found in res["noise"].items():
            assert found["equal"], name
        assert any(found["episodes"] > 0 for found in res["noise"].values())
