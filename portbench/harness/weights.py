"""The weights of a dense decoder LM, made on the device from the seed.

One draw per stacked group (all layers of ``wq`` at once, and so on), in
the dtype the weights are served in: the same seed, shapes and device give
the same bits, so the program and the reference are each handed weights
made the same way, and neither takes them from the other.

Weights are (d_in, d_out) at std d_in ** -0.5 and the embedding at std
d ** -0.5; the norm scales are 1 + 0.1 n and the q, k, v biases 0.1 n
(n standard normal), so that the comparison covers them too.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from portbench.harness.seeds import generator

BIAS_STD = 0.1
SCALE_STD = 0.1


def group_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """``{group: (stacked shape, kind, std)}`` of a dense decoder LM.
    Groups under ``blocks.`` carry a leading layer axis; ``kind`` is
    "normal" (std as given), "scale" (1 + std n) or "bias" (std n)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    out = {
        "embed.table": ((V, d), "normal", d ** -0.5),
        "blocks.ln1.scale": ((L, d), "scale", SCALE_STD),
        "blocks.attn.wq.w": ((L, d, H * hd), "normal", d ** -0.5),
        "blocks.attn.wk.w": ((L, d, KV * hd), "normal", d ** -0.5),
        "blocks.attn.wv.w": ((L, d, KV * hd), "normal", d ** -0.5),
        "blocks.attn.wo.w": ((L, H * hd, d), "normal", (H * hd) ** -0.5),
        "blocks.ln2.scale": ((L, d), "scale", SCALE_STD),
        "blocks.ffn.gate.w": ((L, d, f), "normal", d ** -0.5),
        "blocks.ffn.up.w": ((L, d, f), "normal", d ** -0.5),
        "blocks.ffn.down.w": ((L, f, d), "normal", f ** -0.5),
        "ln_f.scale": ((d,), "scale", SCALE_STD),
        "head.w": ((d, V), "normal", d ** -0.5),
    }
    if cfg.get("qkv_bias"):
        out["blocks.attn.wq.b"] = ((L, H * hd), "bias", BIAS_STD)
        out["blocks.attn.wk.b"] = ((L, KV * hd), "bias", BIAS_STD)
        out["blocks.attn.wv.b"] = ((L, KV * hd), "bias", BIAS_STD)
    return out


def make_group(cfg: dict, group: str, seed: int, device, dtype):
    """The stacked tensor of ``group`` (see :func:`group_shapes`), drawn
    in one call from its own generator, so that groups can be made one
    at a time in any order."""
    import torch

    shape, kind, std = group_shapes(cfg)[group]
    gen = generator(device, seed, "weights", group)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    t.mul_(std)
    if kind == "scale":
        t.add_(1.0)
    return t


def member_names(cfg: dict, group: str) -> Iterator[Tuple[int, str]]:
    """``(layer or -1, parameter name)`` of each member of ``group``, by
    the program's parameter names (``blocks.3.attn.wq.w``)."""
    if not group.startswith("blocks."):
        yield -1, group
        return
    rest = group[len("blocks."):]
    for i in range(cfg["num_hidden_layers"]):
        yield i, f"blocks.{i}.{rest}"


def fill_model(model, cfg: dict, seed: int) -> None:
    """Write the seed's weights into a program model whose parameters
    carry the names above, group by group."""
    import torch

    params = dict(model.named_parameters())
    groups = group_shapes(cfg)
    missing = set(params) - {n for g in groups
                             for _, n in member_names(cfg, g)}
    if missing:
        raise KeyError(f"the model has parameters the benchmark does not "
                       f"make: {sorted(missing)}")
    with torch.no_grad():
        for g in groups:
            first = params[next(member_names(cfg, g))[1]]
            t = make_group(cfg, g, seed, first.device, first.dtype)
            for i, name in member_names(cfg, g):
                params[name].copy_(t if i < 0 else t[i])
            del t


def reference_weights(cfg: dict, seed: int, device):
    """The seed's weights as the reference takes them: made anew, in
    bf16 (the dtype they are served in), a group under ``blocks.`` as a
    list of its layers."""
    import torch

    W = {}
    for g in group_shapes(cfg):
        t = make_group(cfg, g, seed, device, torch.bfloat16)
        W[g] = list(t.unbind(0)) if g.startswith("blocks.") else t
    return W
