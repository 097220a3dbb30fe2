"""Rule ``cache-key``: cache-key discipline for EvalCache and PlanCache.

The invariants it machine-checks (docs/analysis.md):

* every key stored into / looked up from an ``EvalCache`` table
  (``cache.comp`` / ``cache.fits``) is a tuple built by the recognized key
  constructor — a literal prefix followed by the evaluator's ``*…._ck``
  request-context tail — so entries can never silently drop the
  batch/mode/schedule context that keeps heterogeneous fleets safe on one
  shared cache;
* key *families* (distinct literal prefixes) stay **arity-disjoint**: the
  fused 7-tuple ``(node, lo, hi, *_ck)`` and the per-direction 8-tuple
  ``(node, lo, hi, direction, *_ck)`` from the round-trip training model can
  share one dict only because their lengths differ.  A new family whose
  total arity collides with an existing one would alias entries across
  semantics — this rule turns that tribal knowledge into a named finding;
* ``PlanCache`` keys are ProblemInstance **content hashes** (strings from
  ``solve_key``/``content_hash``), never ad-hoc tuples — tuple keys would
  bypass the engine-wide instance identity that makes cached outcomes
  bit-identical to fresh solves.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .astutil import enclosing_function_map, local_assignment
from .base import Finding, ModuleInfo, ProjectContext, Rule, register_rule

EVAL_TABLES = ("comp", "fits")
CK_SUFFIX = "_ck"  # the recognized request-context tail attribute
HASH_PRODUCERS = ("content_hash", "solve_key", "_solve_key", "spec_hash")


def _is_eval_table(node: ast.AST) -> bool:
    """``<something cache-like>.comp`` / ``.fits`` attribute access."""
    if not (isinstance(node, ast.Attribute) and node.attr in EVAL_TABLES):
        return False
    base = ast.unparse(node.value)
    return "cache" in base.lower()


def _key_tuple(module: ModuleInfo, expr: ast.AST, site: ast.AST,
               fn_map: dict) -> ast.Tuple | None:
    """Resolve the key expression at a cache site to its tuple display —
    either written inline or assigned to a local name in the same function."""
    if isinstance(expr, ast.Tuple):
        return expr
    if isinstance(expr, ast.Name):
        fn = fn_map.get(site)
        if fn is not None:
            val = local_assignment(fn, expr.id, before=None)
            if isinstance(val, ast.Tuple):
                return val
    return None


@register_rule
class CacheKeyRule(Rule):
    name = "cache-key"
    description = ("EvalCache keys use the *…_ck constructor and families "
                   "stay arity-disjoint; PlanCache keys are content hashes")

    # ------------------------------------------------------------- per module
    def check_module(self, module: ModuleInfo,
                     ctx: ProjectContext) -> Iterator[Finding]:
        fn_map = enclosing_function_map(module.tree)
        noqa = module.noqa_lines()
        for site, key_expr, table in _eval_sites(module.tree):
            if site.lineno in noqa:
                continue
            tup = _key_tuple(module, key_expr, site, fn_map)
            if tup is None:
                if isinstance(key_expr, ast.Name):
                    continue  # untraceable local — give names the benefit
                yield Finding(
                    self.name, module.relpath, site.lineno,
                    f"EvalCache .{table} key is not a recognized key-"
                    f"constructor tuple",
                    "build the key as a literal tuple ending in the "
                    "evaluator's *…._ck request-context tail, e.g. "
                    "(node, lo, hi, *self._ck)")
                continue
            last = tup.elts[-1] if tup.elts else None
            tail_ok = (isinstance(last, ast.Starred)
                       and isinstance(last.value, ast.Attribute)
                       and last.value.attr.endswith(CK_SUFFIX))
            if not tail_ok:
                yield Finding(
                    self.name, module.relpath, site.lineno,
                    f"EvalCache .{table} key tuple lacks the *…._ck "
                    f"request-context tail",
                    "append *<evaluator>._ck so batch/mode/schedule/"
                    "microbatch context stays part of the memo key")

        for call, key_arg in _plancache_sites(module.tree):
            if call.lineno in noqa:
                continue
            bad = _non_hash_key(module, key_arg, call, fn_map)
            if bad:
                yield Finding(
                    self.name, module.relpath, call.lineno,
                    f"PlanCache key is {bad}, not a ProblemInstance "
                    f"content hash",
                    "key PlanCache entries by the engine-wide content hash "
                    "(ServeRequest.solve_key / ProblemInstance."
                    "content_hash), never ad-hoc tuples")

    # ---------------------------------------------------- cross-file families
    def check_project(self, ctx: ProjectContext) -> Iterator[Finding]:
        # family = normalized literal prefix of a *…_ck key; arity = prefix
        # length (the _ck tail has one fixed length project-wide, so distinct
        # prefix lengths <=> distinct total arities)
        families: dict[tuple[str, ...], tuple[str, int]] = {}
        for module in ctx.modules:
            fn_map = enclosing_function_map(module.tree)
            for site, key_expr, _table in _eval_sites(module.tree):
                tup = _key_tuple(module, key_expr, site, fn_map)
                if tup is None or not tup.elts:
                    continue
                last = tup.elts[-1]
                if not (isinstance(last, ast.Starred)
                        and isinstance(last.value, ast.Attribute)
                        and last.value.attr.endswith(CK_SUFFIX)):
                    continue
                prefix = tuple(ast.unparse(e) for e in tup.elts[:-1])
                where = (module.relpath, site.lineno)
                for seen, (seen_where, seen_line) in families.items():
                    if seen != prefix and len(seen) == len(prefix):
                        yield Finding(
                            self.name, module.relpath, site.lineno,
                            f"EvalCache key family ({', '.join(prefix)}, "
                            f"*_ck) collides in arity with family "
                            f"({', '.join(seen)}, *_ck)",
                            f"key families must stay arity-disjoint so "
                            f"entries never alias in a shared table; the "
                            f"colliding family is at {seen_where}:"
                            f"{seen_line} — add/remove a discriminating "
                            f"prefix element or reuse the existing "
                            f"constructor verbatim")
                        break
                else:
                    families.setdefault(prefix, where)


def _eval_sites(tree: ast.Module):
    """(site-node, key-expr, table) for every EvalCache table access:
    ``cache.comp[key]`` loads/stores and ``cache.comp.get(key)`` lookups."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and _is_eval_table(node.value):
            yield node, node.slice, node.value.attr
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get"
              and _is_eval_table(node.func.value)
              and node.args):
            yield node, node.args[0], node.func.value.attr


def _plancache_sites(tree: ast.Module):
    """(call, key-arg) for ``<plan cache>.get/put`` calls on objects whose
    spelling marks them as a PlanCache."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "put") and node.args):
            continue
        base = ast.unparse(node.func.value)
        if "plan_cache" in base or "PlanCache" in base:
            yield node, node.args[0]


def _non_hash_key(module: ModuleInfo, arg: ast.AST, site: ast.AST,
                  fn_map: dict) -> str | None:
    """A human description of the key if it is visibly *not* a content hash
    (tuple display, non-string constant — directly or through one local
    assignment); None when it is a hash or untraceable (assumed fine)."""
    if isinstance(arg, ast.Name):
        fn = fn_map.get(site)
        val = (local_assignment(fn, arg.id, before=None)
               if fn is not None else None)
        if val is not None:
            arg = val
    if isinstance(arg, ast.Tuple):
        return "a tuple"
    if isinstance(arg, ast.Constant) and not isinstance(arg.value, str):
        return f"a {type(arg.value).__name__} constant"
    return None
