"""repro-lint for the PyTorch/CUDA port — AST-based static enforcement of
the repo's correctness conventions (docs/analysis.md) over ``src/repro_torch``.

The headline guarantees elsewhere in the tree — NumPy/torch bit-parity,
conservation-exact residual accounting, content-hash plan caching — all rest
on conventions (arity-disjoint cache-key families, seeded RNG on solver
paths, registry capability declarations matching solver bodies, every
``ScenarioSpec`` knob hash-relevant).  This package turns those house rules
into machine-checked invariants with rule-named diagnostics:

* :mod:`repro_torch.analysis.base` — ``Rule`` protocol, ``Finding``,
  ``ProjectContext``, the entry point (``run_analysis``);
* :mod:`repro_torch.analysis.baseline` — accepted-finding suppression file
  (``lint_baseline_torch.txt``);
* :mod:`repro_torch.analysis.cli` — ``python -m repro_torch.analysis``
  (exit-code contract: 0 clean / 1 findings / 2 usage error);
* ``rules_cache`` / ``rules_determinism`` / ``rules_registry`` /
  ``rules_spec`` / ``rules_hygiene`` / ``rules_docs`` — the rule catalog.

Pure stdlib by design: the linter runs in environments without the
scientific stack (the CI docs job, pre-commit hooks).  It imports no
``torch``, no ``jax`` and nothing of the JAX package, whose own copy
(``repro.analysis``) checks ``src/repro``.  The rules, messages and exit
codes are that copy's; the one difference is the determinism rule's reach
over torch's global RNG stream (``rules_determinism``).
"""
from .base import (Finding, ModuleInfo, ProjectContext, Rule, get_rules,
                   register_rule, rule_names, run_analysis)
from .baseline import Baseline, load_baseline, save_baseline

__all__ = [
    "Finding", "ModuleInfo", "ProjectContext", "Rule",
    "get_rules", "register_rule", "rule_names", "run_analysis",
    "Baseline", "load_baseline", "save_baseline",
]
