"""Rule ``spec-hash``: every ScenarioSpec knob is hash-relevant.

On-disk sweep caching, serve presolve dedup and twin-pairing all key on the
spec content hash (``ScenarioSpec.key()`` -> ``spec_hash()``): a knob that
changes results but silently falls out of the hash makes two *different*
scenarios collide in the cache — the nastiest possible staleness bug, and
one a downstream parity test only catches by luck.

``key()`` hashes ``to_dict()`` minus an explicit exclusion set, so every
*new* dataclass field is hash-relevant by construction; what this rule pins
down statically is the exclusion set itself:

* every field ``key()`` pops out of the hash must be declared in the
  module-level ``HASH_IRRELEVANT`` allowlist (one place, with a
  justification comment per entry);
* every ``HASH_IRRELEVANT`` entry must still be a real dataclass field
  (stale allowlist entries are findings too);
* every allowlisted field must actually be popped — an allowlisted field
  that ``key()`` still hashes means allowlist and implementation drifted;
* pops that cannot be resolved statically (computed field sets) are flagged:
  the whole point is that the exclusion set is reviewable at a glance.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .astutil import const_str_tuple
from .base import Finding, ModuleInfo, ProjectContext, Rule, register_rule

SPEC_CLASS = "ScenarioSpec"
ALLOWLIST_NAME = "HASH_IRRELEVANT"
KEY_METHOD = "key"


@register_rule
class SpecHashRule(Rule):
    name = "spec-hash"
    description = ("every ScenarioSpec field is content-hashed by key() "
                   "unless declared in the HASH_IRRELEVANT allowlist")

    def check_module(self, module: ModuleInfo,
                     ctx: ProjectContext) -> Iterator[Finding]:
        spec = next((n for n in module.tree.body
                     if isinstance(n, ast.ClassDef) and n.name == SPEC_CLASS),
                    None)
        if spec is None:
            return
        key_fn = next((n for n in spec.body
                       if isinstance(n, ast.FunctionDef)
                       and n.name == KEY_METHOD), None)
        if key_fn is None:
            return

        fields = {n.target.id for n in spec.body
                  if isinstance(n, ast.AnnAssign)
                  and isinstance(n.target, ast.Name)}
        allowlist = _module_allowlist(module.tree)
        popped, via_loop, unresolved = _popped_fields(key_fn, allowlist)

        for line, desc in unresolved:
            yield Finding(
                self.name, module.relpath, line,
                f"{SPEC_CLASS}.key() excludes a field set that cannot be "
                f"resolved statically ({desc})",
                f"pop hash-excluded fields via the module-level "
                f"{ALLOWLIST_NAME} tuple (or literal field names) so the "
                f"exclusion set stays reviewable")
        allowed = set(allowlist or ())
        for name, line in sorted(popped.items()):
            if name not in allowed:
                yield Finding(
                    self.name, module.relpath, line,
                    f"field {name!r} is excluded from the spec content hash "
                    f"but not declared in {ALLOWLIST_NAME}",
                    f"add {name!r} to {ALLOWLIST_NAME} with a justification "
                    f"comment — or stop popping it so it hashes")
            elif name not in fields and name not in via_loop:
                # a stale name reached only through the HASH_IRRELEVANT loop
                # is the *allowlist entry's* fault — reported once below
                yield Finding(
                    self.name, module.relpath, line,
                    f"key() pops {name!r}, which is not a {SPEC_CLASS} "
                    f"field",
                    "remove the stale pop (the field was renamed or "
                    "deleted)")
        if allowlist is not None:
            for name in allowlist:
                if name not in fields:
                    yield Finding(
                        self.name, module.relpath, spec.lineno,
                        f"stale {ALLOWLIST_NAME} entry {name!r}: not a "
                        f"{SPEC_CLASS} field",
                        "remove the entry (the field was renamed or "
                        "deleted)")
                elif name not in popped:
                    yield Finding(
                        self.name, module.relpath, key_fn.lineno,
                        f"field {name!r} is declared hash-irrelevant but "
                        f"key() still hashes it",
                        f"pop it in key() (the canonical form iterates "
                        f"{ALLOWLIST_NAME}) or remove it from the "
                        f"allowlist")


def _module_allowlist(tree: ast.Module) -> list[str] | None:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == ALLOWLIST_NAME:
                    return const_str_tuple(node.value)
    return None


def _popped_fields(
    key_fn: ast.FunctionDef, allowlist: list[str] | None
) -> tuple[dict[str, int], set[str], list[tuple[int, str]]]:
    """Fields ``key()`` pops from the hashed dict: literal ``d.pop("x")``
    strings, plus loops ``for f in HASH_IRRELEVANT: d.pop(f)`` (and loops
    over literal tuples), expanded.  Returns (name -> line, names popped
    only via the HASH_IRRELEVANT loop, unresolved)."""
    popped: dict[str, int] = {}
    via_loop: set[str] = set()
    unresolved: list[tuple[int, str]] = []
    loop_vars: dict[str, list[str]] = {}
    for node in ast.walk(key_fn):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            if (isinstance(node.iter, ast.Name)
                    and node.iter.id == ALLOWLIST_NAME):
                loop_vars[node.target.id] = [f"@{ALLOWLIST_NAME}"]
            else:
                lit = const_str_tuple(node.iter)
                if lit is not None:
                    loop_vars[node.target.id] = lit
    for node in ast.walk(key_fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "pop" and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            popped[arg.value] = node.lineno
        elif isinstance(arg, ast.Name) and arg.id in loop_vars:
            values = loop_vars[arg.id]
            if values == [f"@{ALLOWLIST_NAME}"]:
                for name in (allowlist or ()):
                    popped[name] = node.lineno
                    via_loop.add(name)
                if allowlist is None:
                    unresolved.append(
                        (node.lineno,
                         f"loops over {ALLOWLIST_NAME}, which is not a "
                         f"module-level tuple of string literals"))
            else:
                for name in values:
                    popped[name] = node.lineno
        else:
            unresolved.append(
                (node.lineno, f"pop argument {ast.unparse(arg)!r}"))
    return popped, via_loop, unresolved
