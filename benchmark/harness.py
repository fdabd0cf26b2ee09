"""The benchmark of ``morl_baselines_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a file
found by the name ``BENCHMARK.json`` gives it: ``configs/<config>.json`` (the
algorithm, the env and the hyperparameters as run), ``traffic/<traffic>.json``
(the actor-learner shape: envs, updates a step, batch, replay), ``limits/<cell>.json``
(the limit of each number the check compares), ``algos/<algorithm>.py`` (how the
program is built and driven, its reference, and the GEMMs an iteration needs)
and ``metrics/<metric>.py`` (a reader that returns the metric or None).

A run:
1. builds the agent's state through the program's public API, with Q-net
   weights the benchmark makes on the device from the seed;
2. runs the iterations before ``learning_starts`` and the first three learning
   iterations through the window's own call, reading the losses, Adam's first
   moment, the parameters' change and, with PER, the priorities and the rows
   each update draws (all of this is set-up, counted in ``setup_s``);
3. calls ``train_segment(state, 1)`` for ``--seconds``, recording a CUDA event
   after each call without synchronising; the intervals are read after the
   window's closing synchronise.  Around the first target copy in the window
   it keeps copies of the target's and the online net's leaves;
4. with ``--trace 1``, profiles a stretch of ``profile_iters`` more iterations;
5. reads the peak memory, frees the program's state, runs the reference from
   the same seed through the same iterations (with PER, on the rows the
   program drew, each draw checked against the inverse CDF of the program's
   live priorities) and compares (``check.py``), the target copy with it;
6. fails if JAX or the JAX package was imported; prints the compared numbers
   beside their limits on stderr and the result as the last line of stdout.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from . import check

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "morl_baselines_tpu")
# how many learning iterations the reference follows
COMPARED = 3


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # the BENCHMARK.json entries this cell reports: (entry, kind) with kind "end_to_end" or "per_layer"


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    metrics = [
        (m, kind)
        for kind in ("end_to_end", "per_layer")
        for m in spec[kind]
        if workload in m.get("workloads", [workload])
    ]
    bench = root / BENCH_DIR.name
    return Cell(
        name=workload,
        chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{workload}.json").read_text()),
        metrics=metrics,
    )


def algorithm(name: str):
    return importlib.import_module(f"{__package__}.algos.{name}")


def reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = root / BENCH_DIR.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pin_process(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the checkout,
    and the process and every thread it starts on one core, the last it may
    use.  To be called before torch is imported."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    build = root / "build" / "benchmark"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on the boot clock (from /proc, 10 ms resolution)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ------------------------------------------------------------------ the program


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_params(algo, params: dict, *nets) -> None:
    """The benchmark's weights into the program's nets, every leaf of them."""
    import torch

    for net in nets:
        named = dict(net.named_parameters())
        if len(named) != len(params):
            raise RuntimeError(f"the program's net has {len(named)} leaves, the benchmark made {len(params)}")
        with torch.no_grad():
            for k, v in params.items():
                p, src = named[algo.port_name(k)], algo.to_port(k, v)
                if p.shape != src.shape:
                    raise RuntimeError(f"{k}: the program's leaf is {tuple(p.shape)}, the benchmark's {tuple(src.shape)}")
                p.copy_(src)


def first_learning_iteration(traffic: dict) -> int:
    return math.ceil(traffic["learning_starts"] / traffic["num_envs"])


def follow(cell: Cell, step, loss, leaves, moment, priorities, sampling) -> check.Readings:
    """One side's readings: ``step()`` through the iterations before learning
    starts and the compared learning iterations; ``loss()``, ``leaves()``,
    ``moment()`` and ``priorities()`` (the least and the largest priority
    each row may hold) read its state; ``sampling(readings)`` is entered
    around the compared iterations."""
    readings = check.Readings()
    for _ in range(first_learning_iteration(cell.traffic) - 1):
        step()
    snapshot = lambda: {k: v.detach().clone() for k, v in leaves().items()}  # noqa: E731
    before = snapshot()
    with sampling(readings):
        for i in range(COMPARED):
            step()
            readings.losses.append(float(loss()))
            if i == 0:
                check.record_moment(readings, moment())
                readings.first_change = check.change_norms(before, snapshot())
                if cell.traffic["per"]:
                    readings.priorities = tuple(x.detach().clone() for x in priorities())
    readings.change = check.change_norms(before, snapshot())
    return readings


@contextlib.contextmanager
def recorded_draws(buffer, readings: check.Readings):
    """The program's PER draws kept in ``readings`` (the reference learns on
    the same rows: a draw moves with the last bit of every priority before it),
    and each held against the inverse CDF of the program's live priorities at
    the uniforms its generator is about to give."""
    import torch

    from .reference.common import proportional

    orig = buffer.sample

    def sample(gen, batch_size, *args, **kwargs):
        ahead = torch.Generator(gen.device)
        ahead.set_state(gen.get_state())
        want = proportional(buffer.priorities, torch.rand((batch_size,), generator=ahead, device=gen.device))
        out = orig(gen, batch_size, *args, **kwargs)
        readings.drawn.append(out[1].detach().clone())
        readings.misdrawn += int((out[1] != want).sum())
        return out

    buffer.sample = sample
    try:
        yield
    finally:
        del buffer.sample


class CopyProbe:
    """The first target copy after set-up: copies of the target's leaves
    after the iteration before it and after it, and of the online net's after
    it, taken on the device without a synchronise; ``gaps()`` reads them."""

    def __init__(self, cfg: dict, net, target, done: int):
        freq = cfg["target_net_update_freq"]
        self.at = (done + 1) // freq * freq + freq  # the first multiple of freq after done + 1
        self.net, self.target = net, target
        self.start = self._leaves(target)
        self.before = self.after = self.online = None

    @staticmethod
    def _leaves(net) -> list:
        return [p.detach().clone() for p in net.parameters()]

    def seen(self, done: int) -> None:
        """Called with the count of iterations run, after each."""
        if done == self.at - 1:
            self.before = self._leaves(self.target)
        elif done == self.at:
            self.after, self.online = self._leaves(self.target), self._leaves(self.net)

    def gaps(self) -> dict:
        return check.copy_gaps(self.before, self.after, self.online, self.start)


def program_setup(cell: Cell, seed: int, device):
    """(agent, state, readings, copy probe): the state past ``learning_starts``
    and the compared learning iterations, all through the window's own call."""
    import torch

    from .weights import make_params

    algo = algorithm(cell.config["algorithm"])
    params = make_params(algo.shapes(cell.config), seed, device)
    agent, state, net, target = algo.build(cell.config, cell.traffic, seed, device)
    load_params(algo, params, net, target)
    del params
    named = {k: dict(net.named_parameters())[algo.port_name(k)] for k in algo.shapes(cell.config)}

    def moment():  # an optimizer that has not stepped holds no moment
        opt = state.ts.optimizer.state
        return {k: opt.get(p, {}).get("exp_avg", torch.zeros_like(p)) for k, p in named.items()}

    def sampling(readings):
        return recorded_draws(state.buffer, readings) if cell.traffic["per"] else contextlib.nullcontext()

    probe = CopyProbe(cell.config, net, target, first_learning_iteration(cell.traffic) - 1 + COMPARED)
    readings = follow(cell, lambda: agent.train_segment(state, 1), lambda: state.loss, lambda: named, moment,
                      lambda: (state.buffer.priorities,) * 2, sampling)
    return agent, state, readings, probe


def drive_to_copy(agent, state, probe: CopyProbe, done: int) -> None:
    """Iterations on to the target copy where the window stopped short of it."""
    while done < probe.at:
        agent.train_segment(state, 1)
        done += 1
        probe.seen(done)


def reference_readings(cell: Cell, seed: int, device, precision: str = "f32", draws=None) -> check.Readings:
    """The reference's readings over the same iterations, from the same seed;
    with PER it learns on ``draws``, the rows the other side drew."""
    from .reference.common import full_float32
    from .weights import make_params

    full_float32()
    algo = algorithm(cell.config["algorithm"])
    ref = algo.reference(cell.config, cell.traffic, make_params(algo.shapes(cell.config), seed, device), seed, device, precision)
    if draws is not None:
        ref.buffer.follow = list(draws)
    readings = follow(cell, ref.iterate, lambda: ref.loss, lambda: ref.params, lambda: ref.opt.m,
                      lambda: (ref.buffer.prio_lo, ref.buffer.prio_hi), lambda readings: contextlib.nullcontext())
    readings.drawn = ref.buffer.drawn
    return readings


class Marks:
    """A CUDA event after each call on the card (a host clock read on the CPU,
    where calls are synchronous); intervals are read once the work is done."""

    def __init__(self, device):
        self.cuda, self.marks = device.type == "cuda", []

    def mark(self) -> None:
        import torch

        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


@dataclass
class Window:
    iters: int
    wall_s: float
    intervals_ms: list
    num_envs: int
    setup_s: float
    stretch: object = None  # stretch.Stretch of the traced run
    gemms: list | None = None  # (m, k, n) of an iteration's Q-net GEMMs
    peaks: dict | None = None


def run_window(agent, state, seconds: float, device, probe: CopyProbe, done: int) -> tuple[int, float, list, float]:
    """(iterations, wall seconds, intervals ms, boot-clock time of the opening);
    ``done`` iterations ran before it."""
    marks = Marks(device)
    _sync(device)
    opened = boot_clock()
    t0 = time.perf_counter()
    marks.mark()
    iters = 0
    while time.perf_counter() - t0 < seconds:
        agent.train_segment(state, 1)
        marks.mark()
        iters += 1
        probe.seen(done + iters)
    _sync(device)
    return iters, time.perf_counter() - t0, marks.intervals_ms(), opened


def loop_ms() -> float:
    """The least of 5 timings of a fixed pure-Python loop, in ms: how fast this
    core runs the host's dispatch at the moment (the host's cores run it at
    speeds up to 2x apart, from moment to moment)."""
    best = math.inf
    for _ in range(5):
        t = time.perf_counter()
        sum(range(300_000))
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def profile_stretch(agent, state, iters: int, device):
    """A ``stretch.Stretch`` of ``iters`` iterations under the profiler (host and device)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .stretch import RANGE, reduce

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(RANGE):
            for _ in range(iters):
                agent.train_segment(state, 1)
            _sync(device)
    return reduce(prof.events(), iters)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return "; ".join(out.stdout.strip().splitlines()) or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device, started: float):
    """(result dict, lines for stderr).  ``started``: the process start on the boot clock."""
    import torch

    cell = load_cell(root, workload)
    algo = algorithm(cell.config["algorithm"])
    agent, state, prog, probe = program_setup(cell, seed, device)
    done = first_learning_iteration(cell.traffic) - 1 + COMPARED
    host = [loop_ms()]
    iters, wall, intervals, opened = run_window(agent, state, seconds, device, probe, done)
    host.append(loop_ms())
    win = Window(iters, wall, intervals, cell.traffic["num_envs"], opened - started)
    drive_to_copy(agent, state, probe, done + iters)
    copied = probe.gaps()
    del probe
    if trace:
        win.stretch = profile_stretch(agent, state, cell.traffic["profile_iters"], device)
        win.gemms = algo.gemms(cell.config, cell.traffic)
        win.peaks = json.loads((root / BENCH_DIR.name / "peaks.json").read_text())
    last_loss = float(state.loss)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0}
    del agent, state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry, k in cell.metrics:
        if k == kind:
            value = reader(root, entry["name"])(win)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": False, "attempted": iters, "failed": 0 if math.isfinite(last_loss) else iters,
              "metrics": metrics, "device": dev}
    if trace and win.stretch is not None:
        dev["busy_s"], dev["window_s"] = win.stretch.busy_s, win.stretch.window_s
        result["breakdown"] = {"device_ops": win.stretch.top_device_ops(), "idle_gaps": win.stretch.idle_gaps()}

    gaps = check.compare(prog, reference_readings(cell, seed, device, draws=prog.drawn if cell.traffic["per"] else None))
    gaps |= copied
    result["correct"] = check.verdict(gaps, cell.limits) and math.isfinite(last_loss)
    result["check"] = {k: {"value": gaps[k], "limit": limit} for k, limit in cell.limits.items()}
    lines = [f"[bench] {workload} seed {seed}: {iters} iterations in {wall:.3f} s; device {dev['kind']}; "
             f"nvidia-smi name, power.limit: {power_limit() if device.type == 'cuda' else 'cpu'}",
             f"[bench] host: a fixed Python loop took {host[0]:.3f} ms before the window and {host[1]:.3f} ms after it "
             f"on cores {sorted(os.sched_getaffinity(0))}"]
    lines += [f"[check] {k} {gaps[k]!r} limit {limit!r}" for k, limit in cell.limits.items()]
    return result, lines


def main(argv=None) -> int:
    import argparse

    started = process_start()
    ap = argparse.ArgumentParser(description="one run of one benchmark cell of morl_baselines_torch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH_DIR.parent
    cell = load_cell(root, args.workload)
    pin_process(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, lines = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), started)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the run imported {bad}: the benchmark measures morl_baselines_torch alone", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
