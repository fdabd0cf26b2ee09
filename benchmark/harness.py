"""The benchmark of ``morl_baselines_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a file
found by the name ``BENCHMARK.json`` gives it: ``configs/<config>.json`` (the
algorithm, the env and the hyperparameters as run), ``traffic/<traffic>.json``
(the actor-learner shape: envs, updates a step, batch, replay), ``limits/<cell>.json``
(the limit of each number the check compares), ``algos/<algorithm>.py`` (how the
program is built and driven, its reference, and the GEMMs an iteration needs)
and ``metrics/<metric>.py`` (a reader that returns the metric or None).

An algorithm module (``algos/<algorithm>.py``) gives:

- ``shapes(cfg)``: the benchmark's learnable leaves, ``{name: (shape, fan_in)}``
  (``weights.make_params``); every learnable leaf of the program: an actor's,
  critics' and a temperature's alike;
- ``port_name(name)`` and ``to_port(name, x)``: the program's parameter of a
  leaf, and the leaf in the program's layout;
- ``build(cfg, traffic, seed, device)``: ``(agent, state, net, target)``, every
  leaf in the net and in its target; or ``(agent, state, nets)``, ``nets`` a
  mapping of named modules, each a module, a tensor (a leaf of its own, such
  as a temperature) or an (online, target) pair of modules; a leaf lies in
  the module of ``nets`` that ``port_name``'s first dotted part names, at the
  rest of the name (a tensor's leaf is named by its key alone), and a target
  takes its online module's values;
- ``reference(cfg, traffic, params, seed, device, precision)``: an object with
  ``iterate()``, ``loss``, ``params`` and ``opt.m`` (the first moment, keyed by
  the leaf names, over however many optimizers), with PER ``buffer``
  (``drawn``, ``follow``, ``prio_lo``, ``prio_hi``) and under the Polyak rule
  ``target_params`` (the target's leaves, keyed by the leaf names);
- ``gemms(cfg, traffic)``: the GEMMs one iteration needs;

and may give these hooks, each of which has a default (``DEFAULTS``):

- ``step(agent, state)``: one iteration of the window; ``agent.train_segment(state, 1)``;
- ``env_steps(cfg, traffic)``: the env transitions of one iteration; ``traffic["num_envs"]``;
- ``first_learning_iteration(cfg, traffic)``: the first iteration that
  learns (counted from 1); ``ceil(learning_starts / num_envs)``;
- ``reads(state)``: what the check reads from the program, ``(loss, optimizers,
  buffer)``: the last update's loss (a scalar tensor), the optimizers whose
  ``exp_avg`` make up the first moment, and the buffer (read only with PER);
  ``(state.loss, [state.ts.optimizer], state.buffer)``;
- ``target_rule(cfg)``: ``("copy", every)``, ``("polyak", tau)`` or, for a
  learner without a target, ``("none", None)``;
  ``("copy", cfg["target_net_update_freq"])``.  Under ``"copy"`` the run reads
  the first target copy after set-up (``CopyProbe``); under ``"polyak"`` the
  readings hold the target leaves' change over the compared iterations
  (``check.py``'s ``target_change_gap``).

A run:
1. builds the agent's state through the program's public API, with weights
   the benchmark makes on the device from the seed;
2. runs the iterations before the first that learns and the first three
   learning iterations through the window's own call, reading the losses,
   the first moment, the parameters' change, under the Polyak rule the
   target's change and, with PER, the priorities and the rows each update
   draws (all of this is set-up, counted in ``setup_s``);
3. runs ``step`` for ``--seconds``, recording a CUDA event after each call
   without synchronising; the intervals are read after the window's closing
   synchronise.  Under the copy rule, around the first target copy in the
   window it keeps copies of the target's and the online net's leaves;
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


def _step(agent, state) -> None:
    agent.train_segment(state, 1)


def _reads(state):
    return state.loss, [state.ts.optimizer], state.buffer


DEFAULTS = {
    "step": _step,
    "env_steps": lambda cfg, traffic: traffic["num_envs"],
    "first_learning_iteration": lambda cfg, traffic: math.ceil(traffic["learning_starts"] / traffic["num_envs"]),
    "reads": _reads,
    "target_rule": lambda cfg: ("copy", cfg["target_net_update_freq"]),
}


def hook(algo, name: str):
    """The algorithm module's ``name``, or the harness's default of it."""
    return getattr(algo, name, DEFAULTS[name])


def program_leaves(algo, names, nets: dict) -> tuple[dict, dict]:
    """(online, target): the program's tensor of each leaf ``names`` lists,
    and its target's tensor of each leaf that has a target, in ``nets`` (the
    mapping ``build`` gives; the key None holds a net and its target whose
    parameters ``port_name`` names whole).  Raises where a module has leaves
    that no name reaches."""
    import torch

    online, target, count, named = {}, {}, dict.fromkeys(nets, 0), {}

    def leaf(module, path):
        if isinstance(module, torch.Tensor):
            return module
        if id(module) not in named:
            named[id(module)] = dict(module.named_parameters())
        return named[id(module)][path]

    for k in names:
        port = algo.port_name(k)
        key, path = (None, port) if None in nets else (port.partition(".")[0], port.partition(".")[2])
        pair = nets[key] if isinstance(nets[key], tuple) else (nets[key], None)
        online[k] = leaf(pair[0], path)
        if pair[1] is not None:
            target[k] = leaf(pair[1], path)
        count[key] += 1
    for key, entry in nets.items():
        for module in entry if isinstance(entry, tuple) else (entry,):
            n = 1 if isinstance(module, torch.Tensor) else len(list(module.parameters()))
            if n != count[key]:
                net = "net" if key is None else f"module {key!r}"
                raise RuntimeError(f"the program's {net} has {n} leaves, the benchmark made {count[key]}")
    return online, target


def load_params(algo, params: dict, *nets) -> None:
    """The benchmark's weights into the program: every leaf into each net
    given, or, given the mapping of named modules ``build`` returns, each
    leaf into its module and its target."""
    if len(nets) == 1 and isinstance(nets[0], dict):
        _load(algo, params, program_leaves(algo, params, nets[0]))
    else:
        _load(algo, params, [program_leaves(algo, params, {None: net})[0] for net in nets])


def _load(algo, params: dict, sides) -> None:
    """Each leaf of ``params`` into its tensor in each of ``sides`` (mappings of leaf names) that holds it."""
    import torch

    with torch.no_grad():
        for leaves in sides:
            for k, v in params.items():
                if k not in leaves:
                    continue
                p, src = leaves[k], algo.to_port(k, v)
                if p.shape != src.shape:
                    raise RuntimeError(f"{k}: the program's leaf is {tuple(p.shape)}, the benchmark's {tuple(src.shape)}")
                p.copy_(src)


def first_learning_iteration(cell: Cell) -> int:
    return hook(algorithm(cell.config["algorithm"]), "first_learning_iteration")(cell.config, cell.traffic)


def follow(cell: Cell, step, loss, leaves, moment, priorities, sampling, targets=None) -> check.Readings:
    """One side's readings: ``step()`` through the iterations before learning
    starts and the compared learning iterations; ``loss()``, ``leaves()``,
    ``moment()`` and ``priorities()`` (the least and the largest priority
    each row may hold) read its state, and ``targets()``, where given, the
    target's leaves (the Polyak rule); ``sampling(readings)`` is entered
    around the compared iterations."""
    readings = check.Readings()
    for _ in range(first_learning_iteration(cell) - 1):
        step()
    snapshot = lambda read: {k: v.detach().clone() for k, v in read().items()}  # noqa: E731
    before = snapshot(leaves)
    target_before = snapshot(targets) if targets else None
    with sampling(readings):
        for i in range(COMPARED):
            step()
            readings.losses.append(float(loss()))
            if i == 0:
                check.record_moment(readings, moment())
                readings.first_change = check.change_norms(before, snapshot(leaves))
                if cell.traffic["per"]:
                    readings.priorities = tuple(x.detach().clone() for x in priorities())
    readings.change = check.change_norms(before, snapshot(leaves))
    if targets:
        readings.target_change = check.change_norms(target_before, snapshot(targets))
    return readings


def first_moments(optimizers, leaves: dict) -> dict:
    """Each leaf's first moment (``exp_avg``) in whichever of ``optimizers``
    holds it; zeros for a leaf whose optimizer has not stepped."""
    import torch

    out = {}
    for k, p in leaves.items():
        state = next((opt.state[p] for opt in optimizers if p in opt.state), {})
        out[k] = state.get("exp_avg", torch.zeros_like(p))
    return out


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
    """The first target copy after set-up, every ``every`` iterations: copies
    of the target's leaves after the iteration before it and after it, and of
    the online net's after it, taken on the device without a synchronise;
    ``gaps()`` reads them."""

    def __init__(self, every: int, online: list, target: list, done: int):
        self.at = (done + 1) // every * every + every  # the first multiple of every after done + 1
        self.online_leaves, self.target_leaves = online, target
        self.start = self._copy(target)
        self.before = self.after = self.online = None

    @staticmethod
    def _copy(leaves: list) -> list:
        return [p.detach().clone() for p in leaves]

    def seen(self, done: int) -> None:
        """Called with the count of iterations run, after each."""
        if done == self.at - 1:
            self.before = self._copy(self.target_leaves)
        elif done == self.at:
            self.after, self.online = self._copy(self.target_leaves), self._copy(self.online_leaves)

    def gaps(self) -> dict:
        return check.copy_gaps(self.before, self.after, self.online, self.start)


def program_setup(cell: Cell, seed: int, device):
    """(agent, state, readings, copy probe): the state past the iterations
    before learning starts and the compared learning iterations, all through
    the window's own call; the probe is None under the Polyak rule."""
    from .weights import make_params

    algo = algorithm(cell.config["algorithm"])
    shapes = algo.shapes(cell.config)
    params = make_params(shapes, seed, device)
    agent, state, *nets = algo.build(cell.config, cell.traffic, seed, device)
    online, target = program_leaves(algo, shapes, nets[0] if len(nets) == 1 else {None: tuple(nets)})
    _load(algo, params, (online, target))
    del params
    step, reads = hook(algo, "step"), hook(algo, "reads")

    def sampling(readings):
        return recorded_draws(reads(state)[2], readings) if cell.traffic["per"] else contextlib.nullcontext()

    rule, every = hook(algo, "target_rule")(cell.config)
    done = first_learning_iteration(cell) - 1 + COMPARED
    probe = CopyProbe(every, list(online.values()), list(target.values()), done) if rule == "copy" else None
    readings = follow(cell, lambda: step(agent, state), lambda: reads(state)[0], lambda: online,
                      lambda: first_moments(reads(state)[1], online), lambda: (reads(state)[2].priorities,) * 2,
                      sampling, (lambda: target) if rule == "polyak" else None)
    return agent, state, readings, probe


def drive_to_copy(agent, state, probe: CopyProbe, done: int, step=_step) -> None:
    """Iterations on to the target copy where the window stopped short of it."""
    while done < probe.at:
        step(agent, state)
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
    polyak = hook(algo, "target_rule")(cell.config)[0] == "polyak"
    readings = follow(cell, ref.iterate, lambda: ref.loss, lambda: ref.params, lambda: ref.opt.m,
                      lambda: (ref.buffer.prio_lo, ref.buffer.prio_hi), lambda readings: contextlib.nullcontext(),
                      (lambda: ref.target_params) if polyak else None)
    if cell.traffic["per"]:
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
    num_envs: int  # env transitions of one iteration (the algorithm's ``env_steps``)
    setup_s: float
    stretch: object = None  # stretch.Stretch of the traced run
    gemms: list | None = None  # (m, k, n) of an iteration's Q-net GEMMs
    peaks: dict | None = None


def run_window(agent, state, seconds: float, device, probe: CopyProbe | None, done: int,
               step=_step) -> tuple[int, float, list, float]:
    """(iterations, wall seconds, intervals ms, boot-clock time of the opening);
    ``done`` iterations ran before it."""
    marks = Marks(device)
    _sync(device)
    opened = boot_clock()
    t0 = time.perf_counter()
    marks.mark()
    iters = 0
    while time.perf_counter() - t0 < seconds:
        step(agent, state)
        marks.mark()
        iters += 1
        if probe is not None:
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


def profile_stretch(agent, state, iters: int, device, step=_step):
    """A ``stretch.Stretch`` of ``iters`` iterations under the profiler (host and device)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .stretch import RANGE, reduce

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(RANGE):
            for _ in range(iters):
                step(agent, state)
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
    step = hook(algo, "step")
    agent, state, prog, probe = program_setup(cell, seed, device)
    done = first_learning_iteration(cell) - 1 + COMPARED
    host = [loop_ms()]
    iters, wall, intervals, opened = run_window(agent, state, seconds, device, probe, done, step)
    host.append(loop_ms())
    win = Window(iters, wall, intervals, hook(algo, "env_steps")(cell.config, cell.traffic), opened - started)
    copied = {}
    if probe is not None:
        drive_to_copy(agent, state, probe, done + iters, step)
        copied = probe.gaps()
    del probe
    if trace:
        win.stretch = profile_stretch(agent, state, cell.traffic["profile_iters"], device, step)
        win.gemms = algo.gemms(cell.config, cell.traffic)
        win.peaks = json.loads((root / BENCH_DIR.name / "peaks.json").read_text())
    last_loss = float(hook(algo, "reads")(state)[0])
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
