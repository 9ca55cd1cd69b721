"""Analytic model FLOPs (the 6·N·D / 2·N·D convention) per architecture
(the reference's ``repro.launch.model_flops``).

N counts "active" parameters: the embedding table is excluded (a lookup,
not a product), and MoE expert weights are scaled by top_k / n_experts.
The parameters are counted on a model built on the ``meta`` device, so
nothing is allocated (kimi-k2's 1 T parameters count anywhere), and each
is named by its leaf of the reference's tree (``bridge.leaf_groups``), so
the reference's rules apply to the same names. The ratio of model FLOPs
to the FLOPs a step dispatches (``launch.step_analysis``) then measures
how much of the step's compute is useful.
"""

from __future__ import annotations

import math
from typing import Tuple

from repro_torch.bridge import leaf_groups
from repro_torch.models.base import ArchConfig, ShapeSpec, build_model


def param_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """Returns (total_params, active_params)."""
    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    moe_frac = cfg.top_k / cfg.n_experts if cfg.n_experts else 1.0
    total = 0
    active = 0.0
    for grp in leaf_groups(model):
        n = sum(math.prod(params[m].shape) for m in grp.members)
        total += n
        if "embed" in grp.name and "table" in grp.name:
            continue  # lookup, not matmul
        if "moe" in grp.name and "router" not in grp.name:
            active += n * moe_frac
        else:
            active += n
    return total, int(active)


def _tokens(cfg: ArchConfig, shape: ShapeSpec) -> int:
    if cfg.family == "encdec":
        # the encoder sees seq_len frames, the decoder seq_len / dec_ratio
        # tokens: the blended count
        return shape.global_batch * (
            shape.seq_len + shape.seq_len // cfg.dec_ratio) // 2
    return shape.global_batch * shape.seq_len


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Global model FLOPs of one step of ``shape``'s kind: 6 N per token
    to train, 2 N per token of a prefill, 2 N per sequence of a decode
    step (one token each)."""
    _, n_active = param_counts(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * _tokens(cfg, shape)
    if shape.kind == "prefill":
        return 2.0 * n_active * _tokens(cfg, shape)
    return 2.0 * n_active * shape.global_batch
