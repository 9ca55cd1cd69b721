"""Shared AST helpers for the analysis rules (stdlib-only).

Every rule works on plain ``ast`` trees with parent links attached by
:func:`add_parents`; nothing in this package imports torch or executes
the code under analysis, so ``python -m repro_torch.analysis`` runs in a
bare interpreter. These are the helpers of the reference's
``repro.analysis.astutil`` that the port's three rules use.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]
FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def add_parents(tree: ast.AST) -> ast.AST:
    """Attach a ``.parent`` attribute to every node (idempotent)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]
    tree.parent = None  # type: ignore[attr-defined]
    return tree


def parents(node: ast.AST) -> Iterator[ast.AST]:
    """The chain of ancestors, nearest first (requires add_parents)."""
    cur = getattr(node, "parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "parent", None)


def enclosing(node: ast.AST, kinds) -> Optional[ast.AST]:
    """Nearest ancestor of one of ``kinds`` (requires add_parents)."""
    for p in parents(node):
        if isinstance(p, kinds):
            return p
    return None


def qualname(node: ast.AST) -> str:
    """Dotted path of enclosing defs/classes, e.g. ``Plan.serve_executable``.

    Requires :func:`add_parents`. Lambdas render as ``<lambda>``.
    """
    names: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(cur, FUNCTION_NODES + (ast.ClassDef,)):
            names.append(cur.name)
        elif isinstance(cur, ast.Lambda):
            names.append("<lambda>")
        cur = getattr(cur, "parent", None)
    return ".".join(reversed(names)) or "<module>"


def dotted(node: ast.AST) -> Optional[str]:
    """``Name``/``Attribute`` chains as a dotted string, else None.

    ``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; calls and
    subscripts break the chain (returns None): rules only match
    syntactically obvious uses.
    """
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def param_names(fn: Union[FunctionNode, ast.Lambda]) -> List[str]:
    """All parameter names in order (pos-only, positional, kw-only,
    *args, **kwargs)."""
    a = fn.args
    out = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        out.append(a.vararg.arg)
    if a.kwarg:
        out.append(a.kwarg.arg)
    return out


class _RefVisitor(ast.NodeVisitor):
    def __init__(self, names: Set[str]):
        self.names = names
        self.hits: Set[str] = set()

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and node.id in self.names:
            self.hits.add(node.id)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        shadowed = set(param_names(node)) & self.names
        if shadowed:
            inner = _RefVisitor(self.names - shadowed)
            inner.visit(node.body)
            self.hits |= inner.hits
        else:
            self.generic_visit(node)


def references(expr: ast.AST, names: Set[str]) -> Set[str]:
    """Which of ``names`` the expression reads (loads); a lambda's own
    parameters shadow them in its body."""
    if not names:
        return set()
    v = _RefVisitor(names)
    v.visit(expr)
    return v.hits
