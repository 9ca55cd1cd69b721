"""Import-graph construction and re-export resolution.

The layering rule needs more than "does this file mention a banned
name": a thin client can launder a low-level import through a package
``__init__`` (``from repro_torch.serve import X`` where ``repro_torch.serve``
re-exports ``X`` from a banned module). This module builds the
module-level import graph over every analyzed file and resolves
``(module, name)`` pairs through chains of ``from A import B``
re-exports to the module that actually defines the name.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

from .engine import Module, SourceTree


@dataclasses.dataclass(frozen=True)
class ImportEdge:
    """One imported binding at module top level."""

    module: str      # source module ("repro_torch.serve.cache"); "" for bare
    name: str        # imported symbol; "" for `import x` / `import *`
    bound_as: str    # local binding name
    line: int


def _resolve_relative(importer: str, module: Optional[str],
                      level: int) -> str:
    """Absolute module path for a (possibly relative) ImportFrom."""
    if level == 0:
        return module or ""
    parts = importer.split(".")
    # level 1 = current package: drop the module's own leaf name.
    base = parts[:-level] if len(parts) >= level else []
    if module:
        base = base + module.split(".")
    return ".".join(base)


class ImportGraph:
    """Top-level imports and re-exports of every module in the tree."""

    def __init__(self, tree: SourceTree):
        self.edges: Dict[str, List[ImportEdge]] = {}
        # (module, exported name) -> (source module, source name)
        self.reexports: Dict[Tuple[str, str], Tuple[str, str]] = {}
        for mod in tree:
            self.edges[mod.modname] = self._scan(mod)
        for mod in tree:
            for e in self.edges[mod.modname]:
                if e.name and e.name != "*":
                    self.reexports[(mod.modname, e.bound_as)] = (
                        e.module, e.name)

    @staticmethod
    def _scan(mod: Module) -> List[ImportEdge]:
        out: List[ImportEdge] = []
        for stmt in ast.walk(mod.tree):
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    out.append(ImportEdge(
                        module=a.name, name="",
                        bound_as=a.asname or a.name.split(".")[0],
                        line=stmt.lineno))
            elif isinstance(stmt, ast.ImportFrom):
                src = _resolve_relative(mod.modname, stmt.module, stmt.level)
                for a in stmt.names:
                    out.append(ImportEdge(
                        module=src, name=a.name,
                        bound_as=a.asname or a.name, line=stmt.lineno))
        return out

    def resolve(self, module: str, name: str,
                _depth: int = 0) -> Tuple[str, str]:
        """Follow ``from A import B`` chains to the defining module.

        ``resolve("repro_torch.serve", "make_policy")`` returns
        ``("repro_torch.serve.policy", "make_policy")`` when the package
        ``__init__`` re-exports it. Unknown modules resolve to
        themselves (we only see files under the scan roots).
        """
        seen = set()
        cur = (module, name)
        while cur in self.reexports and cur not in seen:
            seen.add(cur)
            cur = self.reexports[cur]
        return cur

    def imports_of(self, modname: str) -> List[ImportEdge]:
        return self.edges.get(modname, [])
