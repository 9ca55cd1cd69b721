"""Core of ``repro_torch.analysis``: source tree, findings, reports.

The engine parses every ``.py`` file under the requested roots with the
stdlib ``ast`` module, hands the whole tree to each registered rule, and
folds the findings through the baseline into a :class:`Report`. Nothing
here imports torch (or numpy, jax, ``repro``): the analyzer runs in an
interpreter with no accelerator stack installed.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Union

from .astutil import add_parents

PathLike = Union[str, pathlib.Path]

TOOL = "repro_torch.analysis"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``key`` is a line-number-free token chosen by the rule (e.g.
    ``"import:repro_torch.launch.steps"`` or ``"branch:step:x"``); together
    with the rule id and file it forms :attr:`ident`, the stable handle
    a baseline entry suppresses. Line renumbering does not invalidate a
    baseline; moving the offending code to another file does.
    """

    rule: str
    file: str
    line: int
    message: str
    symbol: str = ""
    key: str = ""

    @property
    def ident(self) -> str:
        return f"{self.rule}:{self.file}:{self.key or self.symbol or 'module'}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "symbol": self.symbol,
            "ident": self.ident,
        }

    def render(self) -> str:
        where = f"{self.file}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}{sym}: {self.message}"


@dataclasses.dataclass
class Module:
    """A parsed source file plus the names rules address it by."""

    path: pathlib.Path
    rel: str       # display/baseline path: repo-relative when possible
    modname: str   # dotted module name used by the import graph
    source: str
    tree: ast.Module


class SourceTree:
    """Every parsed module under the scan roots, with lookup helpers."""

    def __init__(self, modules: List[Module], parse_errors: List[Finding]):
        self.modules = modules
        self.parse_errors = parse_errors
        self.by_modname: Dict[str, Module] = {m.modname: m for m in modules}

    def __iter__(self):
        return iter(self.modules)

    def __len__(self) -> int:
        return len(self.modules)


def _modname(path: pathlib.Path, root: pathlib.Path) -> str:
    """Dotted module name for the import graph.

    Files under a ``src`` directory get their canonical installed name
    (``src/repro_torch/serve/cache.py`` -> ``repro_torch.serve.cache``); anything
    else is named relative to its scan root, which is what fixture
    trees and ``benchmarks/`` want.
    """
    parts = list(path.with_suffix("").parts)
    if "src" in parts:
        i = len(parts) - 1 - parts[::-1].index("src")
        mod = parts[i + 1:]
    elif root.is_dir():
        try:
            mod = list(path.with_suffix("").relative_to(root).parts)
        except ValueError:
            mod = [path.stem]
    else:
        mod = [path.stem]
    if mod and mod[-1] == "__init__":
        mod = mod[:-1]
    return ".".join(mod) or path.stem


def _display_path(path: pathlib.Path) -> str:
    cwd = pathlib.Path.cwd()
    try:
        return path.relative_to(cwd).as_posix()
    except ValueError:
        return path.as_posix()


def load_tree(paths: Sequence[PathLike]) -> SourceTree:
    modules: List[Module] = []
    errors: List[Finding] = []
    seen = set()
    for raw in paths:
        root = pathlib.Path(raw).resolve()
        if root.is_dir():
            files = sorted(p for p in root.rglob("*.py")
                           if "__pycache__" not in p.parts)
        elif root.suffix == ".py":
            files = [root]
        else:
            errors.append(Finding(
                rule="PARSE", file=_display_path(root), line=0,
                message="not a python file or directory", key="missing"))
            continue
        for f in files:
            if f in seen:
                continue
            seen.add(f)
            source = f.read_text(encoding="utf-8")
            try:
                tree = ast.parse(source, filename=str(f))
            except SyntaxError as e:
                errors.append(Finding(
                    rule="PARSE", file=_display_path(f),
                    line=e.lineno or 0,
                    message=f"syntax error: {e.msg}", key="syntax"))
                continue
            add_parents(tree)
            modules.append(Module(
                path=f, rel=_display_path(f), modname=_modname(f, root),
                source=source, tree=tree))
    return SourceTree(modules, errors)


@dataclasses.dataclass
class Report:
    """The analyzer's output: what fired, what the baseline absorbed.

    ``ok`` is the CI contract — true iff there are no unbaselined
    findings, no parse failures, and no baseline hygiene errors (stale
    entries, missing justifications).
    """

    findings: List[Finding]
    baselined: List[Finding]
    errors: List[str]
    rule_meta: List[Dict[str, str]]
    files: int

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_json(self) -> Dict[str, object]:
        return {
            "tool": TOOL,
            "ok": self.ok,
            "counts": {
                "files": self.files,
                "findings": len(self.findings),
                "baselined": len(self.baselined),
                "errors": len(self.errors),
            },
            "rules": self.rule_meta,
            "findings": [f.as_dict() for f in self.findings],
            "baselined": [f.as_dict() for f in self.baselined],
            "errors": list(self.errors),
        }


def analyze(paths: Sequence[PathLike], *,
            rules: Optional[Iterable[str]] = None,
            baseline: Optional[PathLike] = None) -> Report:
    """Run the rule suite over ``paths`` and apply the baseline.

    ``rules`` filters by rule id (default: all registered rules).
    ``baseline`` is a path to a baseline file (the port's is
    ``analysis_baseline_torch.json``); pass None to run without
    suppressions.
    """
    from .baseline import Baseline
    from .rules import get_rules

    active = get_rules(rules)
    tree = load_tree(paths)
    findings: List[Finding] = list(tree.parse_errors)
    for rule in active:
        findings.extend(rule.run(tree))
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))

    base = Baseline.load(baseline) if baseline is not None else Baseline()
    kept, suppressed, errors = base.apply(findings)
    return Report(
        findings=kept,
        baselined=suppressed,
        errors=errors,
        rule_meta=[{"id": r.id, "name": r.name, "rationale": r.rationale}
                   for r in active],
        files=len(tree),
    )
