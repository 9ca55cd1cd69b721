"""The paper's evaluation workloads as selectable configs."""

from repro_torch.configs.paper_models import (
    PAPER_MODELS,
    build_paper_graph,
    build_paper_model,
)

__all__ = ["PAPER_MODELS", "build_paper_graph", "build_paper_model"]
