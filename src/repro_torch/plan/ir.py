"""PlanIR: the record every compile-plan pass enriches (one card, no
mesh). Each pass writes what it decided and appends it to ``decisions``,
which ``ExecutionPlan.describe()`` replays."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.base import ArchConfig, ShapeSpec


@dataclasses.dataclass
class PlanIR:
    # -- request ------------------------------------------------------------
    cfg: ArchConfig
    shape: Optional[ShapeSpec]           # None: serve plan (bucketed shapes)
    mode: str
    device_request: Any = None           # None: the card
    quantized: bool = False

    # -- ResolveDevice ------------------------------------------------------
    device: Optional[torch.device] = None

    # -- Quantize -----------------------------------------------------------
    quant: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- Compile ------------------------------------------------------------
    executables: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    # -- audit trail --------------------------------------------------------
    decisions: List[Tuple[str, Dict[str, Any]]] = dataclasses.field(
        default_factory=list)

    def record(self, pass_name: str, **entry: Any) -> None:
        self.decisions.append((pass_name, entry))

    def pass_names(self) -> List[str]:
        return [name for name, _ in self.decisions]
