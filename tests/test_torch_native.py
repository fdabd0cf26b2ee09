"""The port's host library loader against the JAX package's and the Python WFG.

Mirror of ``tests/test_native.py``.  Both loaders run the same C++ source, so
hypervolumes must agree to the last bit and the masks exactly; against the
Python WFG (another summation order) at rel 1e-12.  The port builds its own
copy under ``build/`` and writes nothing to ``native/``.
"""

import numpy as np
import pytest
import torch

from morl_baselines_tpu.utils import native as jnative
from morl_baselines_torch.core.indicators import _hv_wfg, hypervolume
from morl_baselines_torch.core.pareto import filter_pareto_dominated, non_dominated_mask
from morl_baselines_torch.utils import native

torch.set_num_threads(1)
REL = 1e-12
ROOT = native.SOURCE.parents[1]


def _random_front(rng, n, d):
    # points on the positive unit sphere: mutually non-dominated; plus dominated scaled copies
    pts = np.abs(rng.normal(size=(n, d)))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    extra = pts[rng.integers(0, n, size=n // 2)] * rng.uniform(0.2, 0.95, size=(n // 2, 1))
    return np.concatenate([pts, extra])


@pytest.mark.parametrize("d", [2, 3, 4, 5])
def test_hv_matches_jax_loader_and_python_wfg(d):
    rng = np.random.default_rng(d)
    pts = _random_front(rng, 40, d)
    ref = np.full((d,), -0.1)
    got = native.hv_exact(pts, ref)
    if jnative.available():
        assert got == jnative.hv_exact(pts, ref)
    assert got == pytest.approx(_hv_wfg(pts, ref), rel=REL)


def test_hv_with_exact_copies():
    """LCN's buffer: a few distinct 6-D returns, each repeated; the C++ prune
    drops the copies, as the Python WFG's does."""
    rng = np.random.default_rng(0)
    leaves = np.abs(rng.normal(size=(5, 6))) * 3.0
    buf = leaves[rng.integers(0, 5, size=128)]
    got = native.hv_exact(buf, np.zeros(6))
    assert got == pytest.approx(_hv_wfg(np.unique(buf, axis=0), np.zeros(6)), rel=REL)
    assert got == pytest.approx(_hv_wfg(buf, np.zeros(6)), rel=REL)


def test_hv_known_value_and_refusal():
    pts = np.array([[1.0, 2.0], [2.0, 1.0]])
    assert native.hv_exact(pts, np.zeros(2)) == 3.0
    # dominated and below-ref points add nothing
    assert native.hv_exact(np.vstack([pts, [[0.5, 0.5], [-1.0, 5.0]]]), np.zeros(2)) == 3.0
    # the library refuses d > 64: None, and hypervolume runs the Python WFG there
    wide = np.ones((2, 65))
    wide[1, 0] = 2.0
    assert native.hv_exact(wide, np.zeros(65)) is None
    assert hypervolume(wide, np.zeros(65)) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        native.hv_exact(pts, np.zeros(3))


def test_hv_batch():
    rng = np.random.default_rng(3)
    fronts = np.stack([_random_front(rng, 20, 3)[:20] for _ in range(5)])
    got = native.hv_exact_batch(fronts, np.zeros(3))
    np.testing.assert_array_equal(got, [native.hv_exact(f, np.zeros(3)) for f in fronts])
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.hv_exact_batch(fronts, np.zeros(3)))
    for i in range(5):
        assert got[i] == pytest.approx(_hv_wfg(fronts[i], np.zeros(3)), rel=REL)


@pytest.mark.parametrize("d", [2, 4, 6])
def test_pareto_mask_matches_jax_and_port_masks(d):
    rng = np.random.default_rng(11 + d)
    pts = np.vstack([_random_front(rng, 50, d), _random_front(rng, 50, d)[:10]]).astype(np.float32).astype(np.float64)
    pts = np.vstack([pts, pts[:7]])  # exact copies: all kept
    got = native.pareto_mask(pts)
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.pareto_mask(pts))
    np.testing.assert_array_equal(got, non_dominated_mask(torch.as_tensor(pts)).numpy())
    np.testing.assert_array_equal(native.pareto_mask(np.array([[1.0, 1.0], [1.0, 1.0], [0.5, 0.5]])), [True, True, False])


def test_dispatch_hypervolume_and_filter():
    """``hypervolume`` runs the native WFG (bitwise its value); the host filter
    sends archives of 256 rows or more with copies kept to the native mask."""
    rng = np.random.default_rng(5)
    pts = _random_front(rng, 30, 3)
    assert hypervolume(pts, np.zeros(3)) == native.hv_exact(pts, np.zeros(3))
    big = np.vstack([_random_front(rng, 200, 3), _random_front(rng, 200, 3)[:100]])
    assert len(big) >= 256
    np.testing.assert_array_equal(filter_pareto_dominated(big), big[native.pareto_mask(big)])
    np.testing.assert_array_equal(
        filter_pareto_dominated(big[:100]), big[:100][non_dominated_mask(torch.as_tensor(big[:100], dtype=torch.float32)).numpy()]
    )


def _snapshot(d):
    # the JAX package's own loader may (re)build native/libmorl_native.so in another test process
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(d.iterdir()) if p.name != "libmorl_native.so"}


def test_builds_under_build_and_leaves_native_alone(tmp_path):
    """The library is compiled into ``build/morl_torch_kernels/`` under a hash
    of the source, once, through a temporary file; a build writes nothing to ``native/``."""
    assert native.library_path().parent == ROOT / "build" / "morl_torch_kernels"
    assert native.library_path().name.startswith("libmorl_native_")
    before = _snapshot(ROOT / "native")
    lib, seconds = native.build(tmp_path)
    assert lib.parent == tmp_path and lib.exists() and seconds > 0.0
    assert native.build(tmp_path) == (lib, 0.0)  # built once
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]  # the temporary file was moved into place
    assert _snapshot(ROOT / "native") == before
    assert "-o" in native.compile_command(lib) and str(native.SOURCE) in native.compile_command(lib)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build(tmp_path)
