"""The port's Envelope with the NatureCNN Q-net on the pixel stack, against
the benchmark's plain reference (``benchmark/reference/envelope_pixel.py``,
``benchmark/reference/pixel.py``) at the published widths: 4 x 84 x 84
frames, the trunk's 32/64/64 filters and 512 features, the head (256,)*4.
CPU, a tiny traffic (8 envs, batch 8, a 256-row buffer); imports no JAX.

- the wrapper stack's frames, rewards and episode ends, bitwise, over steps
  with resets (frames are integers);
- the Q-net's forward on the benchmark's seeded weights;
- the first three learning iterations of ``Envelope.train_segment`` (the
  losses, Adam's first moment, each leaf's change, the priorities and the
  rows PER drew) against the reference's, through the benchmark's own
  comparison (``benchmark/check.py``);
- the needed work of an iteration (``benchmark/algos/envelope_pixel.py``)
  against a count by hand;
- the reference's TF32 control fails the comparison.
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import check, harness
from benchmark.algos import envelope_pixel as algo
from benchmark.reference.pixel import PixelStack
from benchmark.weights import make_params
from morl_baselines_torch.envs import VectorMOEnv, make
from morl_baselines_torch.models import EnvelopeQNet

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**33 + 41  # more than 32 bits, as a benchmark seed may be
TINY = dict(num_envs=8, gradient_updates=2, batch_size=8, buffer_size=256, per=True, learning_starts=16, profile_iters=2)
CONFIG = json.loads((ROOT / "benchmark/configs/envelope-pixel.json").read_text())
LIMITS = json.loads((ROOT / "benchmark/limits/envelope-pixel.wide.json").read_text())
# the limits of the compared iterations (the target copy's need the run past it: the benchmark's rehearsal)
LEARNING = {k: v for k, v in LIMITS.items() if not k.startswith("copy_")}
# every number of the comparison, here: on the CPU both sides run float32 kernels that differ only in their
# order of summation and read about 1e-7, where the TF32 control reads 2e-4 and more on Adam's first moment
# at this size (the cell's limits are set on the card at the cell's size, where the control reads 1e-3 and more)
CPU_GAP = 1e-5


def _cell(traffic=TINY):
    return harness.Cell(name="envelope-pixel.tiny", chips=1, config=CONFIG, traffic=dict(traffic), limits=LIMITS, metrics=[])


def test_wrapper_stack_frames_bitwise_over_resets():
    """40 random steps of 8 envs: the port's vector env over the registered
    stack against the reference's, obs, final obs, rewards and flags exactly."""
    n = 8
    venv = VectorMOEnv(make("deep-sea-treasure-pixel-stack-v0"), n)
    ref = PixelStack(n, CPU)
    gen = torch.Generator().manual_seed(3)
    state, obs = venv.reset(gen)
    rstate = ref.start()
    assert torch.equal(obs, PixelStack.observe(rstate))
    acts = torch.Generator().manual_seed(4)
    ended = 0
    for _ in range(40):
        a = torch.randint(0, 4, (n,), generator=acts)
        out = venv.step(state, a, gen)
        rstate, robs, rew, term, trunc, final = ref.step(rstate, a, gen)
        assert torch.equal(out.obs, robs) and torch.equal(out.final_obs, final)
        assert torch.equal(out.reward, rew)
        assert torch.equal(out.terminated, term) and torch.equal(out.truncated, trunc)
        ended += int((term | trunc).sum())
        state = out.state
    assert ended >= n  # resets happened, each env's on average


def _nets(precision="f32"):
    """The port's Q-net and the reference on the benchmark's weights from SEED."""
    params = make_params(algo.shapes(CONFIG), SEED, CPU)
    net = EnvelopeQNet(4 * 84 * 84, 4, 2, tuple(CONFIG["hidden"]), image_shape=tuple(CONFIG["image_shape"]))
    harness.load_params(algo, params, net)
    ref = algo.reference(CONFIG, TINY, params, SEED, CPU, precision)
    return net, ref


def test_qnet_forward_matches_the_reference():
    """32 stacks of random frames under random weights.  The port flattens
    the last convolution in (H, W, C) order with its dense kernel permuted to
    match, so the dense layer sums its 3136 terms in another order: 1e-5 of
    the largest |Q| covers that float32 rounding, and the TF32 reference
    reads more than 1e-4 away."""
    net, ref = _nets()
    g = torch.Generator().manual_seed(5)
    obs = torch.randint(0, 256, (32, 4 * 84 * 84), generator=g).float()
    w = torch.rand((32, 2), generator=g)
    w = w / w.sum(-1, keepdim=True)
    with torch.no_grad():
        q, want = net(obs, w), ref.q(ref.params, obs, w)
        control = _nets("tf32")[1]
        q_tf32 = control.q(control.params, obs, w)
    scale = want.abs().max()
    assert q.shape == want.shape == (32, 4, 2)
    assert (q - want).abs().max() <= 1e-5 * scale
    assert (q_tf32 - want).abs().max() > 1e-4 * scale


@pytest.fixture(scope="module")
def readings():
    """The program's and the reference's readings over the first three
    learning iterations (the reference on the rows the program drew), and the
    control's against the reference's (on the rows the control drew)."""
    cell = _cell()
    _, _, prog, _ = harness.program_setup(cell, SEED, CPU)
    ref = harness.reference_readings(cell, SEED, CPU, draws=prog.drawn)
    control = harness.reference_readings(cell, SEED, CPU, "tf32")
    against = harness.reference_readings(cell, SEED, CPU, draws=control.drawn)
    return prog, ref, control, against


def test_three_learning_iterations_match_the_reference(readings):
    """Every number within CPU_GAP, and so within the cell's limits."""
    prog, ref, _, _ = readings
    gaps = check.compare(prog, ref)
    assert check.verdict(gaps, LEARNING), gaps
    assert all(v <= CPU_GAP for v in gaps.values()), gaps
    assert len(prog.losses) == harness.COMPARED and prog.priorities is not None
    assert prog.misdrawn == 0 and len(prog.drawn) == harness.COMPARED * TINY["gradient_updates"]
    assert all(torch.equal(a, b) for a, b in zip(prog.drawn, ref.drawn))


def test_the_control_fails_the_comparison(readings):
    """TF32 operands in the reference's convolutions and GEMMs read ten times CPU_GAP or more."""
    _, _, control, against = readings
    gaps = check.compare(control, against)
    assert max(gaps["first_loss_gap"], gaps["moment_gap"], gaps["first_change_gap"]) > 10 * CPU_GAP, gaps


# by hand: one frame through the trunk, (N·Ho·Wo)·(Cin·kh·kw)·Cout of each convolution and the dense layer,
# twice: conv1 400·256·32, conv2 81·512·64, conv3 49·576·64, dense 3136·512; the head 514·256 + 3·256·256 + 256·8
TRUNK, HEAD = 2 * (400 * 256 * 32 + 81 * 512 * 64 + 49 * 576 * 64 + 3136 * 512), 2 * (514 * 256 + 3 * 256 * 256 + 256 * 8)
# the backward of one frame: every kernel gradient (a forward's worth), the input gradients of the dense layer,
# conv3 and conv2 (not conv1's: its input is data); of one head row: every kernel gradient, the input gradients
# of the head's last four layers and of the first layer's 512 feature inputs (not of w)
TRUNK_BWD = TRUNK + 2 * (3136 * 512 + 49 * 576 * 64 + 81 * 512 * 64)
HEAD_BWD = HEAD + 2 * (512 * 256 + 3 * 256 * 256 + 256 * 8)


def test_needed_work_against_a_count_by_hand():
    assert (TRUNK, HEAD) == (18_685_952, 660_480)
    n, b, w, u = 2048, 256, 4, 8
    update = 3 * b * TRUNK + 3 * b * w * HEAD + b * TRUNK_BWD + b * w * HEAD_BWD
    assert update == 25_620_905_984  # of which 2·B frames through the target side's two trunks: 9.57 GFLOP
    want = n * (TRUNK + HEAD) + u * update
    assert want == 244_588_740_608
    traffic = json.loads((ROOT / "benchmark/traffic/pixel-2048.json").read_text())
    work = algo.gemms(CONFIG, traffic)
    assert sum(2 * m * k * nn for m, k, nn in work) == want
    # the trunk's operations at their true sizes: the same operations less the head's; conv1's forward of the
    # act reads 2048 stacks of 4x84x84, its kernel and writes 2048x32x20x20 floats
    assert sum(f for f, _ in work.trunk) == n * TRUNK + u * (3 * b * TRUNK + b * TRUNK_BWD)
    assert work.trunk[0] == (2 * n * 400 * 256 * 32, 4 * (n * 4 * 84 * 84 + 32 * 4 * 8 * 8 + n * 32 * 20 * 20))
