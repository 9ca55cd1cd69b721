"""repro_torch.analysis — static analysis of the port's serving stack
(the counterpart of ``repro.analysis``).

The runtime gates (the ``ExecutableCache`` counters: zero builds after
warm-up; the parity tests) prove the invariants after the fact; this
package proves them on every commit without running torch. Three rules:

* RA201 ``cachekey-completeness`` — every parameter that reaches a step
  builder maps to a ``CacheKey`` field.
* RA401 ``hot-path-purity`` — no syncs, transfers or tensor allocations
  (``torch.cuda.synchronize``, ``.item()``, ``.cpu()``, ``torch.zeros``,
  ...) in boundary callbacks, admission policies, or the server worker
  loop.
* RA501 ``layering`` — the launchers and the batcher stay thin
  ``repro_torch.plan`` clients (import-graph-aware, resolves re-exports).

Two of the reference's five rules do not apply, and asking for them
(``--rules RA101``) exits 2 with the reason:

* RA101 ``retrace-hazard``: the port is eager PyTorch and traces
  nothing. It has no ``jax.jit``/``lax.scan`` counterpart, no
  ``torch.compile`` and no graph capture, so there is no traced body to
  retrace. A capture rule belongs with the first CUDA graph.
* RA301 ``donation-safety``: the port donates no buffers; its steps
  update their state in place.

CLI: ``python -m repro_torch.analysis [paths...] [--json out.json]``;
see ``docs/port_static_analysis.md`` for the rule catalog and the
baseline workflow. The package is stdlib-only: importing it, or running
the CLI, loads no torch, numpy, jax or ``repro`` module (it reads the
reference's files as text only).
"""

from .engine import Finding, Module, Report, SourceTree, analyze, load_tree
from .baseline import Baseline, write_baseline
from .rules import ALL_RULES, NOT_APPLICABLE, RULES_BY_ID, get_rules

__all__ = [
    "Finding", "Module", "Report", "SourceTree", "analyze", "load_tree",
    "Baseline", "write_baseline",
    "ALL_RULES", "NOT_APPLICABLE", "RULES_BY_ID", "get_rules",
]
