"""Small shared AST helpers for the rule catalog (stdlib ``ast`` only)."""
from __future__ import annotations

import ast
from typing import Iterator


def dotted_name(node: ast.AST) -> str | None:
    """Flatten ``a.b.c`` Attribute/Name chains to ``"a.b.c"`` (None if the
    chain contains anything else — calls, subscripts)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    """Every function/method definition in the module, any nesting depth."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def enclosing_function_map(tree: ast.Module) -> dict[ast.AST, ast.AST]:
    """node -> nearest enclosing function def (module-level nodes absent)."""
    out: dict[ast.AST, ast.AST] = {}

    def visit(node: ast.AST, fn: ast.AST | None) -> None:
        for child in ast.iter_child_nodes(node):
            here = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                here = child
            elif fn is not None:
                out[child] = fn
            visit(child, here)

    visit(tree, None)
    return out


def local_assignment(fn: ast.AST, name: str,
                     before: ast.AST | None = None) -> ast.expr | None:
    """The value last assigned to ``name`` inside function ``fn`` (textually
    before ``before`` when given) — a one-step, same-scope resolution that is
    enough for the ``key = (...)`` / ``use(key)`` idiom the rules check."""
    limit = getattr(before, "lineno", None)
    best: tuple[int, ast.expr] | None = None
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        if limit is not None and node.lineno >= limit:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id == name:
                if best is None or node.lineno > best[0]:
                    best = (node.lineno, node.value)
    return best[1] if best else None


def const_str_tuple(node: ast.AST) -> list[str] | None:
    """Elements of a tuple/list display of string constants, else None."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for el in node.elts:
        if isinstance(el, ast.Constant) and isinstance(el.value, str):
            out.append(el.value)
        else:
            return None
    return out


def call_name(node: ast.Call) -> str | None:
    """The called function's terminal name: ``f(...)`` -> "f",
    ``a.b.f(...)`` -> "f"."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None
