"""Rule registry for ``repro_torch.analysis``.

Each rule is a small object with ``id``/``name``/``rationale`` metadata
and a ``run(tree) -> List[Finding]`` method. Rules are registered here
in id order; ``--rules`` on the CLI and the ``rules=`` kwarg of
:func:`repro_torch.analysis.analyze` filter by id. The reference's RA101
and RA301 have no code to check in the port (:data:`NOT_APPLICABLE`);
asking for either raises ``KeyError`` with the reason.
"""

from __future__ import annotations

from typing import Iterable, Optional

from .cachekey import CacheKeyCompletenessRule
from .hotpath import HotPathPurityRule
from .layering import LayeringRule

ALL_RULES = (
    CacheKeyCompletenessRule(),
    HotPathPurityRule(),
    LayeringRule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}

# the reference's rules that have nothing to check in the port
NOT_APPLICABLE = {
    "RA101": ("retrace-hazard", "the port is eager PyTorch and traces "
              "nothing: it has no jax.jit/lax.scan counterpart, no "
              "torch.compile and no graph capture"),
    "RA301": ("donation-safety", "the port donates no buffers: its steps "
              "update the state in place and return it"),
}


def get_rules(ids: Optional[Iterable[str]] = None):
    if ids is None:
        return list(ALL_RULES)
    ids = list(ids)
    for i in ids:
        if i in NOT_APPLICABLE:
            name, why = NOT_APPLICABLE[i]
            raise KeyError(f"{i} ({name}) does not apply to the port: "
                           f"{why}")
    unknown = [i for i in ids if i not in RULES_BY_ID]
    if unknown:
        raise KeyError(f"unknown rule id(s): {', '.join(unknown)} "
                       f"(have: {', '.join(RULES_BY_ID)})")
    return [RULES_BY_ID[i] for i in ids]


__all__ = [
    "ALL_RULES", "NOT_APPLICABLE", "RULES_BY_ID", "get_rules",
    "CacheKeyCompletenessRule", "HotPathPurityRule", "LayeringRule",
]
