"""Parity of the torch port's core math with the JAX package's.

Points, masks and weights are made with numpy from a seed and handed to
both.  Tolerances: masks exact; host hypervolume rtol 1e-9 (both float64);
device indicators rtol 1e-5 (float32 sums in another order).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morl_baselines_tpu.core import DeviceParetoFront as JDeviceParetoFront
from morl_baselines_tpu.core import ParetoArchive as JParetoArchive
from morl_baselines_tpu.core import indicators as jind
from morl_baselines_tpu.core.pareto import filter_pareto_dominated as j_filter
from morl_baselines_tpu.core.pareto import non_dominated_mask as j_nd_mask
from morl_baselines_tpu.core.weights import equally_spaced_weights as j_esw
from morl_baselines_tpu.evaluation import device_front_metrics as j_device_front_metrics
from morl_baselines_tpu.ops.pareto_kernel import non_dominated_mask_pallas
from morl_baselines_tpu.utils import schedules as jsched
from morl_baselines_torch.core import DeviceParetoFront, ParetoArchive, filter_pareto_dominated, get_non_dominated_inds
from morl_baselines_torch.core import indicators as tind
from morl_baselines_torch.core.pareto import non_dominated_mask
from morl_baselines_torch.core.weights import equally_spaced_weights, random_weights
from morl_baselines_torch.evaluation import device_front_metrics
from morl_baselines_torch.ops.pareto_kernel import (
    COL_TILE,
    MAX_CHUNK_TILES,
    SINGLE_BLOCK_MAX_N,
    WARPS_PER_BLOCK,
    nd_launch_plan,
    non_dominated_mask_auto,
    non_dominated_mask_cuda,
    non_dominated_mask_plain,
    rows_per_thread,
)
from morl_baselines_torch.utils import MetricLogger
from morl_baselines_torch.utils import schedules as tsched

torch.set_num_threads(1)


def _points(seed, n, d, dup_groups=True, grid=False):
    """Normal points (or coarse-grid points, full of ties), planted duplicate
    groups, and a random valid mask."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 4, size=(n, d)).astype(np.float32) if grid else rng.normal(size=(n, d)).astype(np.float32)
    if dup_groups and n >= 20:
        pts[n - 10 :] = pts[rng.integers(0, n - 10, size=10)]
    valid = rng.uniform(size=n) > 0.25
    return pts, valid


@pytest.mark.parametrize("dim,n", [(2, 8), (3, 32), (4, 15)])
def test_equally_spaced_weights_bitwise(dim, n):
    np.testing.assert_array_equal(equally_spaced_weights(dim, n), j_esw(dim, n))


@pytest.mark.parametrize("dist", ["gaussian", "dirichlet"])
def test_random_weights_on_simplex(dist):
    w = random_weights(torch.Generator().manual_seed(0), 3, n=4096, dist=dist)
    assert w.shape == (4096, 3) and w.dtype == torch.float32
    assert (w >= 0).all() and torch.allclose(w.sum(-1), torch.ones(4096))
    if dist == "dirichlet":  # flat Dirichlet: each marginal has mean 1/3, var 1/18
        assert torch.allclose(w.mean(0), torch.full((3,), 1 / 3), atol=0.02)
        assert torch.allclose(w.var(0), torch.full((3,), 1 / 18), atol=0.01)
    with pytest.raises(ValueError):
        random_weights(torch.Generator(), 3, dist="bogus")


@pytest.mark.parametrize("keep_duplicates", [True, False])
@pytest.mark.parametrize("n,d,grid", [(37, 3, False), (300, 4, False), (129, 2, True), (200, 3, True)])
def test_nd_mask_parity(n, d, grid, keep_duplicates):
    """The port's (N, N) mask and the kernel's row-blocked plain version agree
    exactly with the JAX mask and the Pallas kernel (interpret mode): ragged
    N, invalid rows, planted duplicates, coarse grids full of ties."""
    pts, valid = _points(n + d, n, d, grid=grid)
    ref = _check_nd_mask(pts, valid, keep_duplicates)
    assert ref.sum() > 0


def _check_nd_mask(pts, valid, keep_duplicates):
    """Assert the Pallas kernel (interpret mode), the port's (N, N) mask and the
    row-blocked plain version all equal the JAX mask; return the JAX mask."""
    ref = np.asarray(j_nd_mask(jnp.asarray(pts), jnp.asarray(valid), keep_duplicates=keep_duplicates))
    pallas = np.asarray(
        non_dominated_mask_pallas(jnp.asarray(pts), jnp.asarray(valid), keep_duplicates=keep_duplicates, interpret=True)
    )
    np.testing.assert_array_equal(pallas, ref)
    tp, tv = torch.as_tensor(pts), torch.as_tensor(valid)
    np.testing.assert_array_equal(non_dominated_mask(tp, tv, keep_duplicates).numpy(), ref)
    for block_rows in (7, 128, 1024):
        np.testing.assert_array_equal(non_dominated_mask_plain(tp, tv, keep_duplicates, block_rows).numpy(), ref)
    return ref


def _sphere(rng, n, d):
    """Points on the positive orthant of the unit sphere: mutually non-dominated."""
    p = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _hard_points(case, seed=11):
    """Inputs the kernel finds hardest: no early exit, ties everywhere, sorted
    orders, extreme d, infinities, N beside a multiple of the tile (32 columns,
    128 rows) and of the column chunk."""
    rng = np.random.default_rng(seed)
    if case == "front":
        return _sphere(rng, 300, 3), np.ones(300, dtype=bool)
    if case == "archive_add":  # a full archive of 150 front points takes 150 candidates
        front, cand = _sphere(rng, 150, 3), _sphere(rng, 150, 3)
        cand[75:] *= rng.uniform(0.9, 0.999, size=(75, 1)).astype(np.float32)
        cand[rng.integers(0, 150, size=4)] = front[rng.integers(0, 150, size=4)]
        return np.concatenate([front, cand]), np.ones(300, dtype=bool)
    if case == "all_equal":
        return np.full((200, 3), 0.5, dtype=np.float32), rng.uniform(size=200) > 0.3
    if case in ("sorted_ascending", "sorted_descending"):
        pts, valid = _points(seed, 300, 3)
        order = np.argsort(pts[:, 0], kind="stable")
        return pts[order if case == "sorted_ascending" else order[::-1]].copy(), valid
    if case == "d1":
        return rng.integers(0, 20, size=(300, 1)).astype(np.float32), rng.uniform(size=300) > 0.2
    if case == "d16":
        return _points(seed, 200, 16)
    if case == "inf":  # +-inf coordinates on valid rows, all -inf rows, duplicated inf rows
        pts, valid = _points(seed, 200, 3, grid=True)
        pts[rng.uniform(size=pts.shape) < 0.1] = -np.inf
        pts[rng.uniform(size=pts.shape) < 0.05] = np.inf
        pts[:3] = -np.inf
        pts[150:160] = pts[rng.integers(0, 150, size=10)]
        valid[:3] = True
        return pts, valid
    n = int(case.split("=")[1])  # "n=<N>"
    return _points(seed + n, n, 3)


@pytest.mark.parametrize("keep_duplicates", [True, False])
@pytest.mark.parametrize(
    "case",
    ["front", "archive_add", "all_equal", "sorted_ascending", "sorted_descending", "d1", "d16", "inf"]
    + [f"n={n}" for n in (31, 33, 127, 129, 255, 257)],
)
def test_nd_mask_parity_hard_inputs(case, keep_duplicates):
    """The same four-way agreement on the inputs that stress the kernel's
    design: full scans, ties, ordered inputs, d at both ends, infinities, and
    N one off a multiple of the tile and of the single-block limit (256)."""
    pts, valid = _hard_points(case)
    ref = _check_nd_mask(pts, valid, keep_duplicates)
    if case == "all_equal":  # every valid row ties every other: all kept, or only the first
        assert ref.sum() == (valid.sum() if keep_duplicates else 1)
    if case == "front":
        assert ref.all()


@pytest.mark.parametrize("d", [1, 3, 16])
def test_nd_kernel_fast_path_identity(d):
    """The identity the kernel's fast path rests on (csrc/pareto_nd.cu,
    scan_tile_fast), in float32 numpy: for finite points with -0 read as +0,
    x = OR_k bits(v_k - r_k) gives  x >= 0 <=> v >= r  and  x > 0 <=> v
    dominates r.  Subnormals, signed zeros and overflowing differences too."""
    rng = np.random.default_rng(d)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 3e-39, -3e-39, 1.0, -1.0, 3.4e38, -3.4e38, 0.99999994], np.float32)
    pts = np.where(rng.uniform(size=(96, d)) < 0.5, rng.choice(special, size=(96, d)), rng.normal(size=(96, d)))
    pts = pts.astype(np.float32)
    v, r = pts[:, None, :] + np.float32(0), pts[rng.permutation(96)][None, :, :] + np.float32(0)
    with np.errstate(over="ignore"):
        x = np.bitwise_or.reduce((v - r).astype(np.float32).view(np.int32), axis=-1)
    ge = np.all(v >= r, axis=-1)
    np.testing.assert_array_equal(x >= 0, ge)
    np.testing.assert_array_equal(x > 0, ge & np.any(v > r, axis=-1))


def _covered(plan):
    """How many work items the kernel's index math (csrc/pareto_nd.cu:
    nd_mask_kernel) gives each (row tile, column tile) pair under ``plan``."""
    g = np.arange(plan.blocks * plan.warps_per_block)
    g = g[g < plan.row_tiles * plan.n_chunks]
    chunk, rt = g // plan.row_tiles, g % plan.row_tiles
    per_chunk = np.zeros((plan.row_tiles, plan.n_chunks), dtype=np.int64)
    np.add.at(per_chunk, (rt, chunk), 1)
    tile_chunk = np.arange(plan.col_tiles) // plan.chunk_tiles  # the chunk whose range holds each tile
    assert tile_chunk.max(initial=0) < max(plan.n_chunks, 1)
    return per_chunk[:, tile_chunk]


@pytest.mark.parametrize("n", [1, 96, 127, 128, 129, 8192, 131072])
def test_nd_launch_plan_covers_every_pair_once(n):
    for d in (1, 3, 8, 9, 16):
        for sm_count in (1, 8, 66, 132, 264):
            plan = nd_launch_plan(n, d, sm_count)
            assert plan.row_tile == 32 * rows_per_thread(d)
            assert (plan.row_tiles - 1) * plan.row_tile < n <= plan.row_tiles * plan.row_tile
            assert (plan.col_tiles - 1) * COL_TILE < n <= plan.col_tiles * COL_TILE
            assert (plan.n_chunks - 1) * plan.chunk_tiles < plan.col_tiles <= plan.n_chunks * plan.chunk_tiles
            assert plan.chunk_tiles <= MAX_CHUNK_TILES or plan.n_chunks == 1
            assert 1 <= plan.warps_per_block <= WARPS_PER_BLOCK
            items = plan.row_tiles * plan.n_chunks
            assert plan.blocks * plan.warps_per_block - plan.warps_per_block < items <= plan.blocks * plan.warps_per_block
            # one block for small N (no scratch); else scratch for a flag per row and a counter per row tile
            assert (plan.blocks == 1 and plan.scratch_ints == 0) if n <= SINGLE_BLOCK_MAX_N else plan.n_chunks > 1
            if plan.n_chunks > 1:
                assert plan.scratch_ints == plan.row_tiles * plan.row_tile + plan.row_tiles
            np.testing.assert_array_equal(_covered(plan), 1)


def test_nd_mask_auto_on_cpu_takes_the_plain_path():
    pts, valid = _points(5, 64, 3)
    tp, tv = torch.as_tensor(pts), torch.as_tensor(valid)
    before = non_dominated_mask_cuda.launches
    for keep in (True, False):
        got = non_dominated_mask_auto(tp, tv, keep)
        assert torch.equal(got, non_dominated_mask(tp, tv, keep))
    assert non_dominated_mask_cuda.launches == before
    with pytest.raises(ValueError):
        non_dominated_mask_cuda(tp, tv)


@pytest.mark.cuda
def test_nd_mask_cuda_kernel_matches_plain():
    """Runs on a machine with an NVIDIA card (the kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is compiled with nvcc and runs only on the card")
    inputs = [_points(seed, n, d, grid=grid) for seed, (n, d, grid) in enumerate([(37, 3, False), (1000, 3, True), (5000, 8, False), (300, 16, False)])]
    # the single-block and the chunked launch on the hardest inputs: no early exit, near-dominated candidates
    inputs += [_hard_points(case) for case in ("front", "archive_add", "inf", "d1", "n=257")]
    rng = np.random.default_rng(5)
    front, cand = _sphere(rng, 3000, 3), _sphere(rng, 3000, 3)
    cand[1500:] *= rng.uniform(0.9, 0.999, size=(1500, 1)).astype(np.float32)
    cand[rng.integers(0, 3000, size=60)] = front[rng.integers(0, 3000, size=60)]
    inputs += [(np.concatenate([front, cand]), np.ones(6000, dtype=bool)), (_sphere(rng, 5000, 3), np.ones(5000, dtype=bool))]
    for pts, valid in inputs:
        tp, tv = torch.as_tensor(pts, device="cuda"), torch.as_tensor(valid, device="cuda")
        for keep in (True, False):
            got = non_dominated_mask_cuda(tp, tv, keep)
            assert torch.equal(got, non_dominated_mask_plain(tp, tv, keep))


def test_host_filters():
    pts, _ = _points(3, 120, 3)
    pts = pts.astype(np.float64)
    for keep in (True, False):
        np.testing.assert_array_equal(filter_pareto_dominated(pts, keep), j_filter(pts, keep))
    np.testing.assert_array_equal(get_non_dominated_inds(pts), np.flatnonzero(np.asarray(j_nd_mask(jnp.asarray(pts)))))
    assert len(filter_pareto_dominated(np.zeros((0, 3)))) == 0


@pytest.mark.parametrize("d", [2, 3, 4])
def test_host_hypervolume(d):
    rng = np.random.default_rng(d)
    front = rng.uniform(0, 10, size=(40, d))
    ref = np.zeros(d)
    valid = rng.uniform(size=40) > 0.2
    got = tind.hypervolume(front, ref, valid=valid)
    np.testing.assert_allclose(got, jind.hypervolume(front, ref, valid=valid), rtol=1e-9)
    np.testing.assert_allclose(got, jind._hv_wfg(front[valid], ref), rtol=1e-9)
    assert tind.hypervolume(np.zeros((0, d)), ref) == 0.0


@pytest.mark.parametrize("d", [3, 6])
def test_host_hypervolume_with_copies(d):
    """A front of many exact copies (a PCN/LCN buffer holds one row per
    episode): the same volume as its distinct rows and as the JAX package's,
    rtol 1e-9.  The recursion drops the copies (each one kept would double
    the work below it)."""
    rng = np.random.default_rng(10 + d)
    distinct = np.abs(rng.normal(size=(16, d))) + 0.1
    front = distinct[rng.integers(0, 16, size=96)]
    ref = np.zeros(d)
    got = tind.hypervolume(front, ref)
    np.testing.assert_allclose(got, tind.hypervolume(np.unique(front, axis=0), ref), rtol=1e-9)
    np.testing.assert_allclose(got, jind.hypervolume(front, ref), rtol=1e-9)


def test_device_hypervolumes():
    rng = np.random.default_rng(0)
    for d, fn_t, fn_j in ((2, tind.hypervolume_2d, jind.hypervolume_2d), (3, tind.hypervolume_3d, jind.hypervolume_3d)):
        front = rng.uniform(0, 10, size=(50, d)).astype(np.float32)
        front[-5:] = front[:5]  # duplicates
        ref = np.full(d, 1.0, dtype=np.float32)
        valid = rng.uniform(size=50) > 0.2
        got = float(fn_t(torch.as_tensor(front), torch.as_tensor(ref), torch.as_tensor(valid)))
        want = float(fn_j(jnp.asarray(front), jnp.asarray(ref), jnp.asarray(valid)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, jind._hv_wfg(front[valid], ref), rtol=1e-5)


def test_utility_indicators():
    rng = np.random.default_rng(1)
    front = rng.normal(size=(30, 3)).astype(np.float32)
    ref_front = rng.normal(size=(12, 3)).astype(np.float32) + 0.5
    weights = np.abs(rng.normal(size=(16, 3))).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    valid = rng.uniform(size=30) > 0.3
    T = torch.as_tensor
    J = jnp.asarray
    for v in (None, valid):
        tv = None if v is None else T(v)
        jv = None if v is None else J(v)
        pairs = [
            (tind.expected_utility(T(front), T(weights), tv), jind.expected_utility(J(front), J(weights), jv)),
            (
                tind.maximum_utility_loss(T(front), T(ref_front), T(weights), tv),
                jind.maximum_utility_loss(J(front), J(ref_front), J(weights), jv),
            ),
            (tind.cardinality(T(front), tv), jind.cardinality(J(front), jv)),
            (tind.igd(T(front), T(ref_front), tv), jind.igd(J(front), J(ref_front), jv)),
            (tind.sparsity(T(front), tv), jind.sparsity(J(front), jv)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tind.sparsity(T(front[:1]))) == 0.0


def test_device_pareto_front_as_a_set():
    rng = np.random.default_rng(2)
    jf, tf = JDeviceParetoFront.create(16, 3), DeviceParetoFront.create(16, 3, device="cpu")
    for _ in range(4):
        cand = rng.normal(size=(12, 3)).astype(np.float32)
        cand[6:9] = cand[:3]  # duplicates: kept once
        cv = rng.uniform(size=12) > 0.2
        jf = jf.add(jnp.asarray(cand), jnp.asarray(cv))
        tf = tf.add(torch.as_tensor(cand), torch.as_tensor(cv))
        want = np.asarray(jf.values)[np.asarray(jf.valid)]
        got = tf.values[tf.valid].numpy()
        assert len(got) == len(want)
        np.testing.assert_array_equal(np.unique(got, axis=0), np.unique(want, axis=0))
    single = DeviceParetoFront.create(4, 2, device="cpu").add(torch.tensor([1.0, 2.0]))
    assert int(single.valid.sum()) == 1


def test_pareto_archive():
    rng = np.random.default_rng(3)
    ja, ta = JParetoArchive(), ParetoArchive()
    assert ta.front.shape == (0, 0)
    for i, ev in enumerate(rng.integers(0, 5, size=(30, 2)).astype(np.float64)):
        ja.add(f"p{i}", ev)
        ta.add(f"p{i}", ev)
    assert ta.individuals == ja.individuals and len(ta) == len(ja)
    np.testing.assert_array_equal(ta.front, ja.front)


@pytest.mark.parametrize("d", [2, 3])
def test_device_front_metrics_parity(d):
    rng = np.random.default_rng(d)
    front = rng.uniform(0, 5, size=(40, d)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.2
    ref = np.zeros(d, dtype=np.float32)
    w = np.abs(rng.normal(size=(8, d))).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    want = j_device_front_metrics(jnp.asarray(front), jnp.asarray(valid), jnp.asarray(ref), jnp.asarray(w))
    got = device_front_metrics(torch.as_tensor(front), torch.as_tensor(valid), torch.as_tensor(ref), torch.as_tensor(w))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_schedules_parity():
    """The schedule is float32 on both sides: equal at every step, warm-up and
    clipping included; the host helpers are the same numpy code."""
    for args in ((1.0, 50_000, 200, 0.05), (0.0, 8000, 16, 1.0), (1.0, 300, 0, 0.1)):
        initial, decay, warmup, final = args
        for step in (0, 7, warmup, warmup + 1, decay // 3, decay + warmup - 1, decay + warmup, 10 * decay):
            want = float(jsched.linearly_decaying_value(initial, decay, step, warmup, final))
            assert tsched.linearly_decaying_value(initial, decay, step, warmup, final) == want
    rng = np.random.default_rng(4)
    vecs = list(rng.normal(size=(6, 3)))
    vecs += [v + 1e-6 for v in vecs[:3]]
    got, want = tsched.unique_tol(vecs), jsched.unique_tol(vecs)
    assert len(got) == len(want) == 6 and all(np.array_equal(a, b) for a, b in zip(got, want))
    w = rng.dirichlet(np.ones(3), size=12)
    np.testing.assert_array_equal(tsched.nearest_neighbors(w, 3), jsched.nearest_neighbors(w, 3))


def test_metric_logger_jsonl(tmp_path, capsys):
    path = tmp_path / "run" / "metrics.jsonl"
    logger = MetricLogger("t", jsonl_path=path)
    logger.log({"eval/hypervolume": torch.tensor(1.5), "eval/cardinality": 3.0}, 128)
    logger.log({"charts/SPS": 10.0}, 256)
    logger.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines == [
        {"eval/hypervolume": 1.5, "eval/cardinality": 3.0, "global_step": 128},
        {"charts/SPS": 10.0, "global_step": 256},
    ]
    assert "eval/hypervolume=1.5" in capsys.readouterr().out
    MetricLogger("off", jsonl_path=tmp_path / "none.jsonl", enabled=False).log({"x": 1.0}, 0)
    assert not (tmp_path / "none.jsonl").exists()
