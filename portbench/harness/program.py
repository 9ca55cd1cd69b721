"""The system under test: ``repro_torch``, built from a configuration
file and filled with the seed's weights. The only module of the harness
that imports the program (the drivers reach it through here)."""

from __future__ import annotations

from portbench.harness.weights import fill_model

# configuration file key -> the program's ArchConfig field
ARCH_FIELDS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab",
    "head_dim": "head_dim",
    "rope_theta": "rope_theta",
    "qkv_bias": "qkv_bias",
}


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` of the configuration ``cfg``: its
    registered config ``cfg["arch"]`` with every size the file states."""
    from repro_torch.configs import get_config

    base = get_config(cfg["arch"])
    if base.family != "dense":
        raise ValueError(f"{cfg['arch']}: the harness builds dense decoder "
                         f"LMs, not the {base.family!r} family")
    return base.with_(**{field: cfg[key] for key, field in ARCH_FIELDS.items()
                         if key in cfg})


def plan_and_model(cfg: dict, seed: int, device, shape):
    """``(plan, model)``: the plan of ``shape`` (a ``(name, seq, batch,
    kind)`` tuple) and the model holding the seed's weights, installed
    through the plan."""
    from repro_torch.models.base import ShapeSpec, build_model
    from repro_torch.plan import build_plan

    plan = build_plan(arch_config(cfg), ShapeSpec(*shape), device=device)
    model = build_model(plan.cfg, device=plan.device)
    fill_model(model, cfg, seed)
    return plan, plan.load_params(model)


def kernel_launches() -> dict:
    """The program's launch counters of its CUDA kernels that a cell
    reads."""
    from repro_torch.kernels.flash_attention import ops as flash

    return {"flash_attention": flash.launches}
