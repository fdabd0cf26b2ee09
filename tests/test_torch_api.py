"""A signature guard: the port's public surface against the JAX package's.

Every module of ``morl_baselines_tpu/`` has a port at the same relative path
under ``morl_baselines_torch/``.  Each JAX module is read with ``ast`` (never
imported); the port's module is imported.  For each public name the JAX
module defines at its top level (and each name of a package's ``__all__``):

- the name resolves in the port's module;
- every parameter of a function, and of each method a class defines
  (``__init__``, ``__call__`` and the public ones), is a parameter of the
  port's callable of that name, resolved through the port's inheritance; the
  port may add parameters (``device``, generators); where the JAX default is a
  literal the port's default equals it;
- every field of a ``*Config`` dataclass is a field of the port's, with an
  equal literal default;
- every field of a flax module (``parent`` and ``name`` aside) is a parameter
  of the port module's constructor.

NamedTuple states and flax's ``TrainState`` only resolve by name: the port
holds torch modules, optimizers and generators where they hold parameter
trees and keys.  A difference by design is listed in ``ALLOWED_PARAMS`` (a
parameter name, wherever it occurs) or ``ALLOWED`` (one item), each with the
JAX line it stands on and its reason.  The test fails on a gap outside the
lists, on an entry that matches no gap, and on a cited line that does not
name its item.  It imports no JAX.
"""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "morl_baselines_tpu", "morl_baselines_torch"

# a parameter of this name is missing from the port's callables by design, wherever it occurs
ALLOWED_PARAMS = {
    "key": ("envs/base.py:100", "a jax.random key: the port draws from a torch.Generator (`gen`), a seed or handed-over noise"),
    "params": ("agents/envelope.py:306", "a functional parameter tree: the port's nets hold their parameters (`net`, `actor`)"),
    "ts": ("agents/pcn.py:126", "a functional TrainState: the port's state holds its net and optimizer"),
}

# one missing name, parameter, field or default each: "<file>::<qualname>", "<file>::<qualname>(<param>)" or
# "<file>::<qualname>(<param>)=" for a default that differs
ALLOWED = {
    # the five options the JAX package never reads
    "agents/moppo.py::MOPPOConfig.anneal_lr": ("agents/moppo.py:118", "never read: MOPPO's lr is constant in the JAX package"),
    "agents/mosac.py::MOSACConfig.target_net_freq": ("agents/mosac.py:51", "never read: the targets follow tau every update"),
    "agents/mpmoql.py::MPMOQLConfig.use_gpi_policy": ("agents/mpmoql.py:37", "never read by MPMOQLearning"),
    "agents/pql.py::PQL.train(log_every)": ("agents/pql.py:255", "never read by PQL.train"),
    "agents/eupg.py::EUPG.__init__(weights)": ("agents/eupg.py:80", "stored as self.w and never read"),
    # options that no caller in the repo (the JAX package, scripts/, examples/, configs/) sets away from its
    # default: the port holds each at that default as a constant
    "agents/ipro.py::IPROConfig.update_freq": ("agents/ipro.py:100", "never set away from 1: the port recomputes the HVIs every iteration"),
    "agents/ipro.py::IPROConfig.reset_agent": ("agents/ipro.py:105", "never set away from False: each oracle call warm-starts"),
    "agents/ipro.py::IPRO.compute_hvis(num)": ("agents/ipro.py:223", "never passed: the subsample is hvi_samples"),
    "agents/ipro.py::IPRO.select_referent(method)": ("agents/ipro.py:238", "never passed: the referent is the best lower point"),
    "agents/nlmoppo.py::NLMOPPOConfig.norm_adv": ("agents/nlmoppo.py:65", "never set away from True: the advantages are normalized"),
    "agents/nlmoppo.py::NLMOPPOConfig.clip_vloss": ("agents/nlmoppo.py:66", "never set away from True: the value loss is clipped"),
    "agents/nlmoppo.py::NLMOPPOConfig.anneal_lr": ("agents/nlmoppo.py:74", "never set away from True: lr anneals 1 -> 0 a call"),
    "agents/nlmoppo.py::NLMOPPOConfig.ent_ramp_frac": ("agents/nlmoppo.py:79", "never set away from 0.5: the ramp spans half a call"),
    "agents/nlmoppo.py::NLMOPPOConfig.track_best": ("agents/nlmoppo.py:84", "never set away from True: the point is the best iterate's"),
    "agents/nlmoppo.py::NLMOPPOConfig.eval_reps": ("agents/nlmoppo.py:85", "never set away from 5: policy_evaluate's default"),
    "envs/wrappers.py::wrap_pixel_stack(skip)": ("envs/wrappers.py:209", "never passed: the registry's stack skips 4"),
    "envs/wrappers.py::wrap_pixel_stack(size)": ("envs/wrappers.py:209", "never passed: the registry's stack is 84 x 84"),
    "envs/wrappers.py::wrap_pixel_stack(num_stack)": ("envs/wrappers.py:210", "never passed: the registry's stack holds 4 frames"),
    "envs/wrappers.py::wrap_pixel_stack(max_episode_steps)": ("envs/wrappers.py:210", "never passed: the registry's limit is 1000"),
    "envs/wrappers.py::wrap_pixel_stack(flatten)": ("envs/wrappers.py:210", "never passed: the registry's stack is flattened"),
    # options of XLA and of jax.profiler
    "agents/gpils.py::GPILS.train_segment(support_cap)": ("agents/gpils.py:298", "a jit-static padding bound of the support"),
    "agents/gpils.py::GPILS.eval_weights_values(support_cap)": ("agents/gpils.py:429", "a jit-static padding bound of the support"),
    "agents/gpils.py::GPILS.eval_weights_values_padded": (
        "agents/gpils.py:451", "pads the weight batch to a power of two so jit compiles once a bucket; the port has no trace"),
    "agents/gpils_continuous.py::GPILSContinuous.eval_weights_values_padded": (
        "agents/gpils.py:451", "inherited from GPILS in the JAX package: the same jit bucketing"),
    "agents/gpils.py::GPILS.act_eval(support_size)": (
        "agents/gpils.py:412", "masks the rows past the padded support; the port hands act_eval the live rows only"),
    "utils/profiling.py::trace(host_tracer_level)": ("utils/profiling.py:20", "an option of jax.profiler; the port traces with torch.profiler"),
    # the Pallas kernel: the port's kernel is csrc/pareto_nd.cu behind non_dominated_mask_cuda, with no size threshold
    "ops/pareto_kernel.py::TILE": ("ops/pareto_kernel.py:30", "the Pallas kernel's tile; the CUDA kernel's tiles are COL_TILE and its plan"),
    "ops/pareto_kernel.py::non_dominated_mask_pallas": (
        "ops/pareto_kernel.py:79", "the TPU kernel's entry; the port's is non_dominated_mask_cuda"),
    "ops/pareto_kernel.py::PALLAS_MIN_N": (
        "ops/pareto_kernel.py:124", "the size above which the JAX package takes the kernel; the port takes it for every CUDA tensor"),
    # the member axis replaces flax's lifted vmap
    "models/networks.py::ensemble": ("models/networks.py:233", "nn.vmap over stacked params; the port's nets take `members`"),
    "models/__init__.py::ensemble": ("models/__init__.py:16", "the package's re-export of models/networks.py's ensemble"),
    # the functional style: act_eval acts for one observation of a functional policy in the JAX package, for a
    # batch of a module in the port's
    "agents/moppo.py::MOPPO.act_eval(w)": ("agents/moppo.py:300", "the evaluation protocol's slot, never read by MOPPO's policy"),
    "agents/mosac.py::MOSAC.act_eval(w)": ("agents/mosac.py:250", "the evaluation protocol's slot, never read by MOSAC's policy"),
    "agents/mosac.py::MOSACDiscrete.act_eval(w)": ("agents/mosac.py:434", "the evaluation protocol's slot, never read"),
    "agents/pcn.py::PCN.update_model(buffer)": ("agents/pcn.py:207", "a functional buffer: the port's state holds it"),
    "models/networks.py::polyak_update(target_params)": (
        "models/networks.py:46", "functional parameter trees: the port updates `target_net` from `net` in place"),
    "agents/mosac.py::MOSACDiscreteState": (
        "agents/mosac.py:278", "the same fields as MOSACState: the port's one MOSACState holds either actor"),
    # flax module fields that are call-time choices of a torch module
    "models/networks.py::MLP.dtype": ("models/networks.py:131", "the compute dtype is an argument of the port's forward"),
    "models/networks.py::WeightConditionedQNet.dtype": ("models/networks.py:185", "an argument of the port's forward"),
    "models/networks.py::EnvelopeQNet.dtype": ("models/networks.py:217", "an argument of the port's forward"),
    "models/networks.py::BatchRenorm.use_running_average": (
        "models/networks.py:88", "train or eval mode: nn.Module.training in the port"),
    "models/networks.py::MLP.final_activation": (
        "models/networks.py:128", "read only with an output_dim, which no caller in the JAX package passes with it"),
    "agents/pcn.py::PCNModel.continuous": ("agents/pcn.py:47", "never read by the module: the head is the same either way"),
    "models/continuous.py::ContinuousQNet.use_layernorm": ("models/continuous.py:119", "no caller in the JAX package sets it"),
    # the port's own
    "envs/planar.py::PlanarMOEnv.__init__(xml_name)": (
        "envs/planar.py:310", "the port takes the model's constants (envs/planar_models.py), as the card's host has no MuJoCo"),
    "utils/native.py::available": (
        "utils/native.py:86", "the port builds the library at first use and raises if the build fails: there is no fallback to choose"),
    "utils/logging.py::MetricLogger.__init__(project)=": ("utils/logging.py:22", "the port logs to its own wandb project"),
    "envs/planar.py::make_mo_hopper_jx": (
        "envs/planar.py:425", "the JAX registry's lazy-import factory; the port's registry maps the id to MOHopperJX"),
    "envs/planar.py::make_mo_halfcheetah_jx": (
        "envs/planar.py:429", "the JAX registry's lazy-import factory; the port's registry maps the id to MOHalfCheetahJX"),
}


def _modules():
    """(relative path, JAX module name, port module name) of every JAX module."""
    for path in sorted((ROOT / JAX_PKG).rglob("*.py")):
        rel = path.relative_to(ROOT / JAX_PKG)
        parts = rel.with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        yield rel.as_posix(), ".".join((JAX_PKG, *parts)), ".".join((PORT_PKG, *parts))


def _params(fn: ast.FunctionDef, method: bool) -> list:
    """(name, default node or None) of each parameter, self/cls aside."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = list(zip((p.arg for p in pos), defaults)) + [(p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return out[1:] if method and not _decorated(fn, "staticmethod") else out


def _decorated(node, name: str) -> bool:
    return any(ast.unparse(d).split("(")[0].split(".")[-1] == name for d in node.decorator_list)


def _literal(node):
    try:
        return True, ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return False, None


def _fields(cls: ast.ClassDef) -> list:
    return [(n.target.id, n.value) for n in cls.body if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]


def _check_params(tag: str, params: list, port_fn, gaps: set) -> None:
    try:
        sig = inspect.signature(port_fn)
    except (TypeError, ValueError):
        gaps.add(f"{tag} (no signature)")
        return
    for name, default in params:
        if name not in sig.parameters:
            gaps.add(f"{tag}({name})")
            continue
        ok, value = _literal(default) if default is not None else (False, None)
        if ok and sig.parameters[name].default != value:
            gaps.add(f"{tag}({name})=")


def _check_class(rel: str, cls: ast.ClassDef, port_cls, gaps: set) -> None:
    tag = f"{rel}::{cls.name}"
    bases = {ast.unparse(b) for b in cls.bases}
    if "NamedTuple" in bases or cls.name == "TrainState":
        return
    if "nn.Module" in bases:  # flax fields are the constructor's parameters
        ctor = inspect.signature(port_cls).parameters
        for name, _ in _fields(cls):
            if name not in ctor:
                gaps.add(f"{tag}.{name}")
        return
    if cls.name.endswith("Config") and dataclasses.is_dataclass(port_cls):
        port_fields = {f.name: f for f in dataclasses.fields(port_cls)}
        for name, default in _fields(cls):
            if name not in port_fields:
                gaps.add(f"{tag}.{name}")
                continue
            ok, value = _literal(default) if default is not None else (False, None)
            if ok and port_fields[name].default != value:
                gaps.add(f"{tag}.{name}=")
        return
    for fn in cls.body:
        if not isinstance(fn, ast.FunctionDef) or (fn.name.startswith("_") and fn.name not in ("__init__", "__call__")):
            continue
        port_fn = getattr(port_cls, fn.name, None)
        if port_fn is None:
            gaps.add(f"{tag}.{fn.name}")
        elif not _decorated(fn, "property"):
            _check_params(f"{tag}.{fn.name}", _params(fn, method=True), port_fn, gaps)


def surface_gaps() -> set:
    """Every difference of the port's public surface from the JAX package's (the module docstring's rules)."""
    gaps = set()
    for rel, _, port_name in _modules():
        tree = ast.parse((ROOT / JAX_PKG / rel).read_text())
        port = importlib.import_module(port_name)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names = [t.id for t in targets if isinstance(t, ast.Name)]
                if "__all__" in names:
                    names = ast.literal_eval(node.value)
            else:
                continue
            for name in names:
                if name.startswith("_"):
                    continue
                obj = getattr(port, name, None)
                if obj is None:
                    gaps.add(f"{rel}::{name}")
                elif isinstance(node, ast.FunctionDef):
                    _check_params(f"{rel}::{name}", _params(node, method=False), obj, gaps)
                elif isinstance(node, ast.ClassDef):
                    _check_class(rel, node, obj, gaps)
    return gaps


def _allowed(gap: str) -> bool:
    param = gap[gap.index("(") + 1 : gap.index(")")] if gap.endswith(")") else None
    return gap in ALLOWED or (param in ALLOWED_PARAMS)


def test_port_surface_matches_the_jax_package():
    gaps = surface_gaps()
    assert not sorted(g for g in gaps if not _allowed(g)), "the port lacks these (or list each with its reason)"
    assert not sorted(set(ALLOWED) - gaps), "allowed differences that no longer exist"


@pytest.mark.parametrize("entry", sorted(ALLOWED) + sorted(ALLOWED_PARAMS))
def test_allowed_difference_cites_its_line(entry):
    """Each entry's cited JAX line names the item, so a citation goes stale loudly."""
    cite, reason = ALLOWED.get(entry) or ALLOWED_PARAMS[entry]
    item = entry.rstrip("=").rstrip(")").split("(")[-1].split(".")[-1].split("::")[-1]
    path, line = cite.split(":")
    assert reason and item in (ROOT / JAX_PKG / path).read_text().splitlines()[int(line) - 1]


def _config_with(cls, drop: str | None = None, **defaults):
    """A copy of the dataclass ``cls`` without the field ``drop`` and with other defaults."""
    fields = []
    for f in dataclasses.fields(cls):
        if f.name != drop:
            kw = dict(default_factory=f.default_factory) if f.default is dataclasses.MISSING else dict(default=defaults.get(f.name, f.default))
            fields.append((f.name, f.type, dataclasses.field(**kw)))
    return dataclasses.make_dataclass(cls.__name__, fields)


def _mutations():
    """(what is broken, how, the gap it must show): one removal or change of each kind the guard reads."""
    from morl_baselines_torch.agents import ipro, nlmoppo
    from morl_baselines_torch.envs import wrappers

    return [
        ("function", lambda mp: mp.delattr(wrappers, "wrap_pixel_stack"), "envs/wrappers.py::wrap_pixel_stack"),
        ("parameter", lambda mp: mp.setattr(wrappers, "wrap_pixel_stack", lambda e: e), "envs/wrappers.py::wrap_pixel_stack(env)"),
        ("method", lambda mp: mp.delattr(ipro.IPRO, "select_referent"), "agents/ipro.py::IPRO.select_referent"),
        ("method parameter", lambda mp: mp.setattr(ipro.IPRO, "update_found", lambda self, referent: None),
         "agents/ipro.py::IPRO.update_found(vec)"),
        ("config field", lambda mp: mp.setattr(nlmoppo, "NLMOPPOConfig", _config_with(nlmoppo.NLMOPPOConfig, "clip_coef")),
         "agents/nlmoppo.py::NLMOPPOConfig.clip_coef"),
        ("config default", lambda mp: mp.setattr(ipro, "IPROConfig", _config_with(ipro.IPROConfig, tolerance=0.5)),
         "agents/ipro.py::IPROConfig.tolerance="),
    ]


@pytest.mark.parametrize("case", range(6), ids=[m[0] for m in _mutations()])
def test_guard_catches_a_removal(case, monkeypatch):
    """Each kind of drift the guard reads, made on the imported port, shows as a gap outside the allowlists."""
    _, mutate, gap = _mutations()[case]
    mutate(monkeypatch)
    gaps = surface_gaps()
    assert gap in gaps and not _allowed(gap)
