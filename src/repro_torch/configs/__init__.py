"""Selectable configs: the paper's evaluation workloads and the assigned
architectures.

``get_config(name)`` returns an architecture's full published config and
``reduced_config(name)`` a structure-preserving small variant for CPU tests
(same family and topology, tiny widths). The registry keeps every id and
alias of the reference, and the port carries every one of them
(``PORTED_IDS``); ``PENDING_FAMILIES`` is empty.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.paper_models import (
    PAPER_MODELS,
    build_paper_graph,
    build_paper_model,
)
from repro_torch.models.base import ArchConfig

ARCH_IDS: List[str] = [
    "llama_3_2_vision_90b",
    "rwkv6_7b",
    "yi_6b",
    "qwen1_5_4b",
    "mistral_large_123b",
    "qwen1_5_110b",
    "phi3_5_moe_42b",
    "kimi_k2_1t",
    "seamless_m4t_large_v2",
    "zamba2_2_7b",
]

# architectures whose config (and family) the port carries
PORTED_IDS: List[str] = list(ARCH_IDS)

# the family of each id the port does not carry yet (its error names the
# roadmap item that ports it); none is left
PENDING_FAMILIES: Dict[str, str] = {}

# CLI aliases (assignment spelling -> module name)
ALIASES: Dict[str, str] = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "rwkv6-7b": "rwkv6_7b",
    "yi-6b": "yi_6b",
    "qwen1.5-4b": "qwen1_5_4b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen1.5-110b": "qwen1_5_110b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_archs() -> List[str]:
    """Every architecture id (the reference's ``list_archs``)."""
    return list(ARCH_IDS)


def reduced_config(name: str) -> ArchConfig:
    """Tiny structure-preserving config of the same family (CPU tests)."""
    cfg = get_config(name)
    kw = dict(
        n_layers=4, d_model=64, n_heads=4, n_kv=min(cfg.n_kv, 2) or 2,
        d_ff=128, vocab=256, head_dim=16, remat=False, q_chunk=32,
        ssd_chunk=8,
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_d_ff=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family == "vlm":
        kw.update(cross_attn_every=2, n_layers=4, n_image_tokens=8)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_layers=2, n_kv=4, dec_ratio=2)
    if cfg.family == "ssm":
        kw.update(ssm_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(attn_every=2, n_layers=4, ssm_state=8, ssm_head_dim=16,
                  n_kv=4, head_dim=16)
    return cfg.with_(**kw)


__all__ = ["ALIASES", "ARCH_IDS", "PAPER_MODELS", "PENDING_FAMILIES",
           "PORTED_IDS", "build_paper_graph", "build_paper_model",
           "get_config", "list_archs", "reduced_config"]
