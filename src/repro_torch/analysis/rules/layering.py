"""RA501 — layering/altitude enforcement, for the port.

The launchers and the batcher are thin ``repro_torch.plan`` clients:
they describe *what* to run and let the plan decide meshes, placements,
step construction and the step cache. The moment a thin client builds a
mesh, imports a step builder, or compiles or captures a function itself,
the cache's build counters stop seeing part of what runs.

The rule works on the import graph, as the reference's
(``repro.analysis.rules.layering``): a ``from repro_torch.serve import
X`` is resolved through package ``__init__`` re-exports to the module
that defines ``X``, so a banned symbol cannot be laundered through a
shim module. Only the tables are the port's: its thin clients (the
reference's, without ``benchmarks/``, which the port does not have), its
modules, and torch's compile, graph-capture and mesh calls in place of
``jax.jit``, ``pjit`` and ``Mesh``. The reference's ``.lower(...)`` check
has no counterpart: torch has no ahead-of-time lowering, and the name
would only catch ``str.lower``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..engine import Finding, Module, SourceTree
from ..graph import ImportGraph
from .. import astutil as A

# Thin plan clients, matched by path suffix (fixture trees mirror the
# same shape under tests/torch_analysis_fixtures/).
THIN_CLIENTS = (
    "launch/train.py",
    "launch/serve.py",
    "launch/dryrun.py",
    "serve/batcher.py",
)

# module (prefix) -> why a thin client must not import from it
BANNED_MODULES: Dict[str, str] = {
    "repro_torch.dist.sharding": "placements and activation layouts are "
                                 "resolved by the plan's ResolveSharding "
                                 "pass and its sharding context",
    "repro_torch.launch.mesh": "meshes are built by the plan's ResolveMesh "
                               "pass",
    "repro_torch.launch.steps": "step builders are bound by the plan's "
                                "Compile pass via the ExecutableCache",
    "repro_torch.kernels": "kernels are an implementation detail of the "
                           "layers",
    "repro_torch.layers": "layers are consumed through the models/plan, "
                          "not directly",
}

# symbols banned regardless of which module re-exports them: the
# reference's list, and ``specs_to_placements``, the port's name for
# ``specs_to_shardings``
BANNED_SYMBOLS = {
    "make_production_mesh", "make_debug_mesh", "rules_for_mode",
    "specs_to_shardings", "specs_to_placements", "make_train_step",
    "make_serve_step", "make_prefill_step", "make_prefill_decode_step",
    "make_masked_decode_step",
}

_COMPILES = ("compiles outside the plan's ExecutableCache — invisible to "
             "its build counters")
_CAPTURES = ("captures a CUDA graph outside the plan's ExecutableCache — "
             "invisible to its build counters")
_MESH = "constructs a mesh outside the plan's ResolveMesh pass"
# by dotted name as written
BANNED_CALLS = {
    "torch.compile": _COMPILES,
    "torch.jit.script": _COMPILES,
    "torch.jit.trace": _COMPILES,
    "torch.cuda.graph": _CAPTURES,
    "torch.cuda.CUDAGraph": _CAPTURES,
    "torch.cuda.make_graphed_callables": _CAPTURES,
}
# by the last name, however it was imported
BANNED_CALL_NAMES = {
    "DeviceMesh": _MESH,
    "init_device_mesh": _MESH,
}


def _banned_module(module: str) -> Optional[Tuple[str, str]]:
    for prefix, why in BANNED_MODULES.items():
        if module == prefix or module.startswith(prefix + "."):
            return prefix, why
    return None


def is_thin_client(rel: str) -> bool:
    return any(rel.endswith(suffix) for suffix in THIN_CLIENTS)


class LayeringRule:
    id = "RA501"
    name = "layering"
    rationale = ("the launchers and the batcher must stay thin "
                 "repro_torch.plan clients — step, mesh, and placement "
                 "decisions that bypass the plan escape its cache "
                 "counters and its pass pipeline")

    def run(self, tree: SourceTree) -> List[Finding]:
        graph = ImportGraph(tree)
        findings: List[Finding] = []
        for mod in tree:
            if not is_thin_client(mod.rel):
                continue
            findings.extend(self._check_imports(mod, graph))
            findings.extend(self._check_calls(mod))
        return findings

    def _check_imports(self, mod: Module,
                       graph: ImportGraph) -> List[Finding]:
        findings: List[Finding] = []
        for edge in graph.imports_of(mod.modname):
            if edge.name:  # from M import N — resolve re-exports
                origin_mod, origin_name = graph.resolve(edge.module,
                                                        edge.name)
                hit = _banned_module(origin_mod)
                laundered = origin_mod != edge.module
                via = (f" (imported via {edge.module}, defined in "
                       f"{origin_mod})") if laundered else ""
                if hit is not None:
                    findings.append(Finding(
                        rule=self.id, file=mod.rel, line=edge.line,
                        key=f"import:{origin_mod}:{origin_name}",
                        message=(f"thin client imports `{origin_name}` "
                                 f"from `{origin_mod}`{via}: {hit[1]}")))
                elif origin_name in BANNED_SYMBOLS:
                    findings.append(Finding(
                        rule=self.id, file=mod.rel, line=edge.line,
                        key=f"import-symbol:{origin_name}",
                        message=(f"thin client imports plan-internal "
                                 f"symbol `{origin_name}`{via} — go "
                                 f"through repro_torch.plan instead")))
            else:  # import M
                hit = _banned_module(edge.module)
                if hit is not None:
                    findings.append(Finding(
                        rule=self.id, file=mod.rel, line=edge.line,
                        key=f"import:{edge.module}",
                        message=(f"thin client imports `{edge.module}`: "
                                 f"{hit[1]}")))
        return findings

    def _check_calls(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = A.qualname(node)
            name = A.call_name(node)
            if not name:
                continue
            leaf = name.split(".")[-1]
            why = BANNED_CALLS.get(name) or BANNED_CALL_NAMES.get(leaf)
            if why is not None:
                findings.append(Finding(
                    rule=self.id, file=mod.rel, line=node.lineno,
                    symbol=qn, key=f"call:{name}:{qn}",
                    message=f"thin client calls `{name}`: {why}"))
            elif leaf in BANNED_SYMBOLS:
                findings.append(Finding(
                    rule=self.id, file=mod.rel, line=node.lineno,
                    symbol=qn, key=f"call:{leaf}:{qn}",
                    message=(f"thin client calls plan-internal "
                             f"`{name}` — steps come from "
                             f"repro_torch.plan")))
        return findings
