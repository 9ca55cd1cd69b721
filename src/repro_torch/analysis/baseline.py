"""Baseline (allowlist) handling for ``repro_torch.analysis``.

A baseline entry suppresses exactly one finding ident and must carry a
written justification — the file is the audit trail for every invariant
we have consciously decided to waive. Two hygiene rules keep it honest:

* an entry with a missing/empty ``justification`` is an error, and
* an entry that no current finding matches is an error (stale
  suppressions would otherwise hide future regressions silently).

Schema (``analysis_baseline_torch.json`` at the repo root)::

    {
      "version": 1,
      "suppressions": [
        {"ident": "RA501:src/foo/launch/x.py:import:repro_torch.layers",
         "justification": "reads layer shape tables only; no steps"}
      ]
    }
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .engine import Finding

PathLike = Union[str, pathlib.Path]

VERSION = 1


class Baseline:
    def __init__(self, entries: Optional[List[Dict[str, str]]] = None,
                 errors: Optional[List[str]] = None):
        self.entries = entries or []
        self.load_errors = errors or []

    @classmethod
    def load(cls, path: PathLike) -> "Baseline":
        p = pathlib.Path(path)
        if not p.exists():
            return cls()
        try:
            data = json.loads(p.read_text(encoding="utf-8"))
        except (json.JSONDecodeError, OSError) as e:
            return cls(errors=[f"baseline {p}: unreadable ({e})"])
        errors: List[str] = []
        if not isinstance(data, dict) or data.get("version") != VERSION:
            errors.append(f"baseline {p}: expected version {VERSION}")
            return cls(errors=errors)
        entries = data.get("suppressions", [])
        if not isinstance(entries, list):
            errors.append(f"baseline {p}: 'suppressions' must be a list")
            return cls(errors=errors)
        clean: List[Dict[str, str]] = []
        for i, e in enumerate(entries):
            if not isinstance(e, dict) or not e.get("ident"):
                errors.append(f"baseline {p}: entry {i} has no 'ident'")
                continue
            if not str(e.get("justification", "")).strip():
                errors.append(
                    f"baseline {p}: entry '{e['ident']}' has no "
                    f"justification — every suppression must say why")
                continue
            clean.append({"ident": str(e["ident"]),
                          "justification": str(e["justification"])})
        return cls(clean, errors)

    def apply(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[str]]:
        """Split findings into (kept, suppressed) and report hygiene
        errors (load problems + stale entries)."""
        idents = {e["ident"] for e in self.entries}
        kept: List[Finding] = []
        suppressed: List[Finding] = []
        used = set()
        for f in findings:
            if f.ident in idents:
                suppressed.append(f)
                used.add(f.ident)
            else:
                kept.append(f)
        errors = list(self.load_errors)
        for e in self.entries:
            if e["ident"] not in used:
                errors.append(
                    f"baseline: stale suppression '{e['ident']}' matches "
                    f"no current finding — remove it")
        return kept, suppressed, errors


def write_baseline(path: PathLike, findings: Sequence[Finding],
                   justification: str) -> None:
    """Write a baseline suppressing ``findings`` (test/tooling helper;
    production baselines are edited by hand with per-entry reasons)."""
    data = {
        "version": VERSION,
        "suppressions": [
            {"ident": f.ident, "justification": justification}
            for f in sorted({f.ident: f for f in findings}.values(),
                            key=lambda f: f.ident)
        ],
    }
    pathlib.Path(path).write_text(
        json.dumps(data, indent=2) + "\n", encoding="utf-8")
