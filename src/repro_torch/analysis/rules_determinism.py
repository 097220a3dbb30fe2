"""Rule ``determinism``: no wall clock, no unseeded RNG on solver/sim paths.

Bit-parity harnesses (NumPy vs torch solvers), conservation replay
(``replay_verify_sim``) and content-hash caching all assume solver, serve,
MSL and sweep code is a *deterministic function of its inputs*.  This rule
flags, inside the checked subtrees (``core/``, ``serve/``, ``msl/``,
``sweep/`` — ``launch/`` and ``benchmarks/`` are allowlisted because
launching and benchmarking legitimately read the clock):

* wall-clock reads: ``time.time()``, ``time.time_ns()``,
  ``datetime.now()`` / ``utcnow()`` / ``today()`` — replayable code takes
  timestamps as parameters; interval timing uses ``time.perf_counter()``
  (monotonic, never used as data), which is allowed;
* module-level global-state RNG: ``np.random.<sampler>`` and stdlib
  ``random.<sampler>`` calls — these draw from hidden global streams that
  any import can perturb;
* unseeded generator construction: ``np.random.default_rng()`` /
  ``random.Random()`` with no seed argument.

Seeded construction (``random.Random(seed)``, ``default_rng(seed)``,
``np.random.Philox(key=...)``) is the approved idiom and passes untouched.

The port's translation of the rule (the JAX package's copy checks only the
NumPy and stdlib streams above; its ``jax.random`` is functional and has no
global stream to guard).  torch has one, and the port's idiom replaces it
with an explicit generator threaded from the caller
(``generator=torch.Generator(device).manual_seed(seed)``).  So the rule also
flags, in the same subtrees and under the same rule name:

* torch's global-stream samplers called without a ``generator=`` keyword:
  ``torch.{rand, randn, randint, randperm, normal, bernoulli, multinomial,
  poisson}`` and their ``_like`` forms;
* the Tensor in-place samplers (``.normal_``, ``.uniform_``, ``.random_``,
  ``.exponential_``, ``.bernoulli_``, ``.geometric_``, ``.log_normal_``,
  ``.cauchy_``) called without ``generator=``;
* reseeding the global stream, as ``np.random.seed`` does:
  ``torch.manual_seed`` / ``torch.seed``, ``torch.random.manual_seed`` /
  ``torch.random.seed`` and ``torch.cuda.{manual_seed, manual_seed_all,
  seed, seed_all}``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .astutil import dotted_name
from .base import Finding, ModuleInfo, ProjectContext, Rule, register_rule

CHECKED_DIRS = frozenset({"core", "serve", "msl", "sweep"})
ALLOWED_DIRS = frozenset({"launch", "benchmarks"})  # timing is their job

WALL_CLOCK = {
    "time.time": "time.time()",
    "time.time_ns": "time.time_ns()",
    "datetime.now": "datetime.now()",
    "datetime.utcnow": "datetime.utcnow()",
    "datetime.today": "datetime.today()",
    "date.today": "date.today()",
}

NP_SAMPLERS = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "uniform", "normal", "standard_normal",
    "poisson", "exponential", "binomial", "beta", "gamma", "seed",
})
PY_SAMPLERS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "expovariate",
    "betavariate", "triangular", "seed", "getrandbits",
})

TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson",
})
TORCH_SAMPLERS = TORCH_SAMPLERS | {f"{s}_like" for s in TORCH_SAMPLERS}
TENSOR_SAMPLERS = frozenset({
    "normal_", "uniform_", "random_", "exponential_", "bernoulli_",
    "geometric_", "log_normal_", "cauchy_",
})
TORCH_RESEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})

_RNG_FIX = ("thread a seeded generator from the caller "
            "(random.Random(seed) / np.random.default_rng(seed)) instead of "
            "the global stream")
_TORCH_RNG_FIX = ("thread a seeded generator from the caller and pass it "
                  "as generator=torch.Generator(device).manual_seed(seed) "
                  "instead of drawing from torch's global stream")
_CLOCK_FIX = ("wall-clock reads break replay determinism; take timestamps "
              "as parameters, or use time.perf_counter() for wall-time "
              "stats that are never inputs")


def _in_scope(relpath: str) -> bool:
    parts = relpath.split("/")[:-1]
    if any(p in ALLOWED_DIRS for p in parts):
        return False
    return any(p in CHECKED_DIRS for p in parts)


@register_rule
class DeterminismRule(Rule):
    name = "determinism"
    description = ("no wall-clock or unseeded/global RNG in core/, serve/, "
                   "msl/, sweep/ (launch/ and benchmarks are allowlisted)")

    def check_module(self, module: ModuleInfo,
                     ctx: ProjectContext) -> Iterator[Finding]:
        if not _in_scope(module.relpath):
            return
        noqa = module.noqa_lines()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or node.lineno in noqa:
                continue
            seeded = any(kw.arg == "generator" for kw in node.keywords)
            # torch Tensor in-place samplers, on any receiver ------------
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in TENSOR_SAMPLERS and not seeded):
                yield Finding(
                    self.name, module.relpath, node.lineno,
                    f"global-stream RNG call .{node.func.attr}() without "
                    f"generator=", _TORCH_RNG_FIX)
                continue
            dn = dotted_name(node.func)
            if dn is None:
                continue
            # wall clock --------------------------------------------------
            for suffix, label in WALL_CLOCK.items():
                if dn == suffix or dn.endswith("." + suffix):
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        f"wall-clock call {label} in deterministic path",
                        _CLOCK_FIX)
                    break
            else:
                parts = dn.split(".")
                # numpy global-state RNG ----------------------------------
                if (len(parts) >= 3 and parts[-2] == "random"
                        and parts[0] in ("np", "numpy")
                        and parts[-1] in NP_SAMPLERS):
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        f"global-stream RNG call {dn}()", _RNG_FIX)
                elif dn.endswith("random.default_rng") and not (
                        node.args or node.keywords):
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        "unseeded np.random.default_rng()",
                        "pass an explicit seed: np.random.default_rng(seed)")
                # stdlib global-state RNG ---------------------------------
                elif (len(parts) == 2 and parts[0] == "random"
                        and parts[1] in PY_SAMPLERS):
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        f"global-stream RNG call {dn}()", _RNG_FIX)
                elif dn == "random.Random" and not (
                        node.args or node.keywords):
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        "unseeded random.Random()",
                        "pass an explicit seed: random.Random(seed)")
                # torch global-stream RNG ---------------------------------
                elif (len(parts) == 2 and parts[0] == "torch"
                        and parts[1] in TORCH_SAMPLERS and not seeded):
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        f"global-stream RNG call {dn}() without generator=",
                        _TORCH_RNG_FIX)
                elif dn in TORCH_RESEEDS:
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        f"global-stream RNG call {dn}()", _TORCH_RNG_FIX)
