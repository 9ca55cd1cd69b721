"""RA201 — cache-key completeness.

Two steps that differ in any parameter that shapes them must get
distinct ``CacheKey``s, or the ``ExecutableCache`` silently serves one
bound step for both. In the port a "build" binds a step function to its
shapes and a "compile-affecting" parameter is anything the builder binds,
but the hazard is the reference's: its ``steps`` and ``paged`` fields
were each added by hand after the parameter already existed, and this
rule makes forgetting the next one a failure. The logic and the messages
are the reference's (``repro.analysis.rules.cachekey``).

The rule is structural, not name-bound to ``ExecutionPlan``: for every
class it checks

1. **key constructor coverage** — in the class's key method (any method
   whose body constructs a ``CacheKey``), every parameter must be
   referenced in the ``CacheKey(...)`` call, and every keyword passed
   to ``CacheKey`` must be a real field of the ``CacheKey`` dataclass
   found in the tree;
2. **builder-parameter coverage** — in any method that both builds
   executables (contains lambdas or ``make_*`` builder calls) and calls
   ``self.<key method>(...)``, every method parameter consumed by a
   builder expression must also be passed to the key call. A parameter
   that shapes the compiled computation but not the key is exactly the
   cache-collision bug.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from ..engine import Finding, SourceTree
from .. import astutil as A

BUILDER_CALL_RE = re.compile(r"^make_\w+$")
KEY_CLASS = "CacheKey"


def _method_params(fn) -> Set[str]:
    return {p for p in A.param_names(fn) if p not in ("self", "cls")}


def _cachekey_calls(fn) -> List[ast.Call]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = A.call_name(node)
            if name and name.split(".")[-1] == KEY_CLASS:
                out.append(node)
    return out


def _call_refs(call: ast.Call, names: Set[str]) -> Set[str]:
    hit: Set[str] = set()
    for a in list(call.args) + [k.value for k in call.keywords]:
        hit |= A.references(a, names)
    return hit


class CacheKeyCompletenessRule:
    id = "RA201"
    name = "cachekey-completeness"
    rationale = ("every compile-affecting parameter that reaches an "
                 "executable builder must map to a CacheKey field — a "
                 "missing field makes two different compilations share "
                 "one cache entry")

    def run(self, tree: SourceTree) -> List[Finding]:
        fields = self._cachekey_fields(tree)
        findings: List[Finding] = []
        for mod in tree:
            for cls in ast.walk(mod.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                findings.extend(self._check_class(mod, cls, fields))
        return findings

    @staticmethod
    def _cachekey_fields(tree: SourceTree) -> Optional[Set[str]]:
        """Field names of the CacheKey dataclass, if it is in the tree."""
        for mod in tree:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and node.name == KEY_CLASS:
                    return {s.target.id for s in node.body
                            if isinstance(s, ast.AnnAssign)
                            and isinstance(s.target, ast.Name)}
        return None

    def _check_class(self, mod, cls: ast.ClassDef,
                     fields: Optional[Set[str]]) -> List[Finding]:
        findings: List[Finding] = []
        methods = {s.name: s for s in cls.body
                   if isinstance(s, A.FUNCTION_NODES)}

        # The class's key method(s): any method that constructs CacheKey.
        key_methods: Dict[str, List[ast.Call]] = {}
        for name, fn in methods.items():
            calls = _cachekey_calls(fn)
            if calls:
                key_methods[name] = calls

        for name, calls in key_methods.items():
            fn = methods[name]
            params = _method_params(fn)
            referenced: Set[str] = set()
            for call in calls:
                referenced |= _call_refs(call, params)
                if fields is not None:
                    for kw in call.keywords:
                        if kw.arg and kw.arg not in fields:
                            findings.append(Finding(
                                rule=self.id, file=mod.rel,
                                line=call.lineno,
                                symbol=f"{cls.name}.{name}",
                                key=f"unknown-field:{cls.name}.{name}:"
                                    f"{kw.arg}",
                                message=(f"CacheKey has no field "
                                         f"`{kw.arg}` — keyword does "
                                         f"not match the dataclass in "
                                         f"serve/cache.py")))
            for p in sorted(params - referenced):
                findings.append(Finding(
                    rule=self.id, file=mod.rel, line=fn.lineno,
                    symbol=f"{cls.name}.{name}",
                    key=f"missing-from-key:{cls.name}.{name}:{p}",
                    message=(f"parameter `{p}` of {cls.name}.{name} "
                             f"never reaches the CacheKey constructor — "
                             f"executables differing only in `{p}` "
                             f"would collide")))

        # Builder methods: call a key method AND build executables.
        for name, fn in methods.items():
            if name in key_methods:
                continue
            key_calls = [
                node for node in ast.walk(fn)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in key_methods
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"]
            if not key_calls:
                continue
            params = _method_params(fn)
            builder_refs: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Lambda):
                    builder_refs |= A.references(node, params)
                elif isinstance(node, ast.Call):
                    cname = A.call_name(node)
                    base = cname.split(".")[-1] if cname else ""
                    if BUILDER_CALL_RE.match(base):
                        builder_refs |= _call_refs(node, params)
            keyed: Set[str] = set()
            for call in key_calls:
                keyed |= _call_refs(call, params)
            for p in sorted(builder_refs - keyed):
                findings.append(Finding(
                    rule=self.id, file=mod.rel, line=fn.lineno,
                    symbol=f"{cls.name}.{name}",
                    key=f"unkeyed-param:{cls.name}.{name}:{p}",
                    message=(f"compile-affecting parameter `{p}` of "
                             f"{cls.name}.{name} is consumed by an "
                             f"executable builder but never passed to "
                             f"the cache key — add it to the key method "
                             f"and a CacheKey field")))
        return findings
