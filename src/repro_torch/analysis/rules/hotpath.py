"""RA401 — hot-path purity, for torch.

The scheduler's boundary callbacks, the admission policies, and the
async server's worker loop run between every micro-run dispatch. A host
sync (``torch.cuda.synchronize``, ``.item()``, ``.tolist()``), a device
transfer (``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``np.asarray`` of a
tensor), or a fresh tensor (``torch.zeros``, ``torch.tensor``, ...)
there stalls the dispatch pipeline for every request in the batch: the
port's serving is host-bound, so every microsecond of this bookkeeping
is a microsecond the card waits. All device work belongs in the
sanctioned dispatch path (``_dispatch`` / ``run``), not in the
per-boundary host bookkeeping.

Hot scopes are identified structurally, as the reference's rule finds
them (``repro.analysis.rules.hotpath``), so fixtures and future code are
covered without configuration:

* every non-dunder method of ``AdmissionPolicy`` and its subclasses;
* the boundary/bookkeeping methods of ``ContinuousScheduler`` and the
  worker-loop methods of ``AsyncServeServer`` (by name);
* any function or method assigned to an ``on_boundary`` /
  ``on_tokens`` / ``on_shed`` hook attribute.

Only the table of banned calls is torch's. ``torch.cuda.set_device``
(the worker binds its thread to the plan's card once) is no sync and is
not in it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..engine import Finding, Module, SourceTree
from .. import astutil as A

POLICY_BASE = "AdmissionPolicy"
HOT_METHODS: Dict[str, Set[str]] = {
    "ContinuousScheduler": {"_admit", "_free", "_now", "cancel",
                            "drain_shed"},
    "AsyncServeServer": {"_worker", "_drain_intake", "_apply",
                         "_boundary_hook", "_emit_tokens",
                         "_notify_shed", "_post", "_finish"},
}
HOOK_ATTRS = {"on_boundary", "on_tokens", "on_shed"}

_ALLOC = "allocates a fresh tensor"
BANNED_EXACT = {
    "torch.cuda.synchronize": "forces a host sync",
    "torch.tensor": _ALLOC,
    "torch.as_tensor": _ALLOC,
    "torch.zeros": _ALLOC,
    "torch.ones": _ALLOC,
    "torch.empty": _ALLOC,
    "torch.full": _ALLOC,
    "torch.arange": _ALLOC,
    "torch.from_numpy": _ALLOC,
    "np.asarray": "may force a device->host transfer",
    "np.array": "may force a device->host transfer",
    "numpy.asarray": "may force a device->host transfer",
    "numpy.array": "may force a device->host transfer",
    "time.sleep": "blocks the dispatch thread",
}
# method calls on any receiver, by attribute name
BANNED_METHODS = {
    "synchronize": "forces a host sync",
    "item": "forces a device->host transfer and a host sync",
    "tolist": "forces a device->host transfer and a host sync",
    "cpu": "forces a device->host transfer",
    "numpy": "forces a device->host transfer",
}
_TO_CPU = "forces a device->host transfer"


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def banned_call(call: ast.Call) -> Optional[Tuple[str, str]]:
    """``(shown name, reason)`` when ``call`` is banned in a hot scope."""
    name = A.call_name(call)
    if name in BANNED_EXACT:
        return name, BANNED_EXACT[name]
    if _to_cpu(call):
        return '.to("cpu")', _TO_CPU
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in BANNED_METHODS:
        return f".{call.func.attr}", BANNED_METHODS[call.func.attr]
    return None


class HotPathPurityRule:
    id = "RA401"
    name = "hot-path-purity"
    rationale = ("boundary callbacks, admission policies, and the "
                 "server worker loop run between every dispatch — a "
                 "sync, transfer, or tensor allocation there stalls "
                 "the whole batch")

    def run(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        for mod in tree:
            for fn, why in hot_scopes(mod):
                findings.extend(self._check(mod, fn, why))
        return findings

    def _check(self, mod: Module, fn, why: str) -> List[Finding]:
        findings: List[Finding] = []
        qn = A.qualname(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            hit = banned_call(node)
            if hit is None:
                continue
            shown, reason = hit
            findings.append(Finding(
                rule=self.id, file=mod.rel, line=node.lineno, symbol=qn,
                key=f"impure:{qn}:{shown}",
                message=(f"`{shown}` in hot path ({why}): {reason}; "
                         f"device work belongs in the dispatch path, "
                         f"not per-boundary bookkeeping")))
        return findings


# -- hot-scope discovery (the reference's) -----------------------------------


def hot_scopes(mod: Module) -> List[Tuple[ast.AST, str]]:
    """``(function node, why)`` of every hot scope in ``mod``."""
    out: List[Tuple[ast.AST, str]] = []
    seen: Set[int] = set()

    def add(fn, why: str):
        if isinstance(fn, A.FUNCTION_NODES) and id(fn) not in seen:
            seen.add(id(fn))
            out.append((fn, why))

    classes = [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]
    policy_like = _policy_classes(classes)
    methods_by_class: Dict[str, Dict[str, ast.AST]] = {}
    for cls in classes:
        methods = {s.name: s for s in cls.body
                   if isinstance(s, A.FUNCTION_NODES)}
        methods_by_class[cls.name] = methods
        if cls.name in policy_like:
            for name, m in methods.items():
                if not name.startswith("__"):
                    add(m, f"{POLICY_BASE} method")
        if cls.name in HOT_METHODS:
            for name in HOT_METHODS[cls.name] & set(methods):
                add(methods[name], f"{cls.name} hot method")
    # f assigned to a boundary hook attribute is a hot callback.
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Attribute)
                        and t.attr in HOOK_ATTRS for t in node.targets)):
            continue
        v = node.value
        if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                and v.value.id == "self":
            cls = A.enclosing(node, (ast.ClassDef,))
            if isinstance(cls, ast.ClassDef):
                m = methods_by_class.get(cls.name, {}).get(v.attr)
                if m is not None:
                    add(m, "boundary hook target")
        elif isinstance(v, ast.Name):
            target = _resolve_local_def(node, v.id)
            if target is not None:
                add(target, "boundary hook target")
    return out


def _policy_classes(classes: List[ast.ClassDef]) -> Set[str]:
    """AdmissionPolicy plus everything that (transitively, within this
    module) inherits from it."""
    bases = {c.name: {A.dotted(b) or "" for b in c.bases} for c in classes}
    hot = {c.name for c in classes
           if c.name == POLICY_BASE
           or any(b.split(".")[-1] == POLICY_BASE for b in bases[c.name])}
    changed = True
    while changed:
        changed = False
        for c in classes:
            if c.name not in hot and any(
                    b.split(".")[-1] in hot for b in bases[c.name]):
                hot.add(c.name)
                changed = True
    return hot


def _resolve_local_def(node: ast.AST, name: str):
    for scope in A.parents(node):
        if isinstance(scope, A.FUNCTION_NODES + (ast.Module,)):
            for s in getattr(scope, "body", []):
                if isinstance(s, A.FUNCTION_NODES) and s.name == name:
                    return s
    return None
