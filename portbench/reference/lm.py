"""A dense decoder LM in plain PyTorch, fp32: the reference of the yi-6b
cells.

Pre-norm blocks: RMSNorm, grouped-query self-attention with rotary
embeddings (rotate-half) and optional q, k, v biases, a residual add,
RMSNorm, a SwiGLU MLP, a residual add; a final RMSNorm and an untied LM
head. Weights are (d_in, d_out), by the benchmark's group names
(``portbench.harness.weights``): ``W[group]`` is a tensor, or for a group
under ``blocks.`` a list with one tensor per layer. Weights of any float
dtype are used in fp32. Every product runs in fp32 with TF32 off
(``fp32_matmul``), attention over query chunks so that a long context
fits.

``prec`` (``reference.precision``) rounds where the program stores: FP32
rounds nothing; a control rounds to a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Union

import torch
import torch.nn.functional as F

from portbench.reference.precision import FP32, Precision

Weights = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]


@contextlib.contextmanager
def fp32_matmul():
    """fp32 products with TF32 off, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def layer_weight(W: Weights, group: str, layer: int) -> torch.Tensor:
    w = W[group]
    if isinstance(w, (list, tuple)):
        w = w[layer]
    return w.float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotate-half rotary embedding of x [B, S, H, hd] at positions [S]."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[:, None] * inv                 # [S, hd/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, q0: int, prec: Precision):
    """Causal attention of the queries q [B, H, c, hd] at positions q0..
    over the keys k, v [B, H, S, hd] at positions 0..; fp32 softmax."""
    c, S = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    qpos = torch.arange(q0, q0 + c, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    p = prec.act(torch.softmax(s, dim=-1))
    return torch.matmul(p, v)


def attention(q, k, v, prec: Precision, chunk: int):
    """q [B, S, H, hd], k and v [B, S, KV, hd] -> [B, S, H, hd]."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2)
    k = torch.repeat_interleave(k, G, dim=2).transpose(1, 2)
    v = torch.repeat_interleave(v, G, dim=2).transpose(1, 2)
    outs = []
    for i in range(0, S, chunk):
        outs.append(_attend(q[:, :, i:i + chunk], k[:, :, :i + chunk],
                            v[:, :, :i + chunk], i, prec))
    return torch.cat(outs, dim=2).transpose(1, 2)


def linear(x, w, b, prec: Precision):
    y = prec.act(torch.matmul(prec.act(x), prec.weight(w)))
    return y if b is None else prec.act(y + b)


def block(x, ws: Dict[str, torch.Tensor], cfg: dict, positions,
          prec: Precision):
    B, S, _ = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    h = prec.act(rmsnorm(x, ws["ln1.scale"], eps))
    q = linear(h, ws["attn.wq.w"], ws.get("attn.wq.b"), prec)
    k = linear(h, ws["attn.wk.w"], ws.get("attn.wk.b"), prec)
    v = linear(h, ws["attn.wv.w"], ws.get("attn.wv.b"), prec)
    q = prec.act(rope(q.view(B, S, H, hd), positions, cfg["rope_theta"]))
    k = prec.act(rope(k.view(B, S, KV, hd), positions, cfg["rope_theta"]))
    o = attention(q, k, v.view(B, S, KV, hd), prec, cfg.get(
        "reference_q_chunk", 512))
    x = prec.act(x + linear(prec.act(o.reshape(B, S, H * hd)),
                            ws["attn.wo.w"], None, prec))
    h = prec.act(rmsnorm(x, ws["ln2.scale"], eps))
    g = linear(h, ws["ffn.gate.w"], None, prec)
    u = linear(h, ws["ffn.up.w"], None, prec)
    a = prec.act(F.silu(g) * u)
    return prec.act(x + linear(a, ws["ffn.down.w"], None, prec))


BLOCK_KEYS = ("ln1.scale", "attn.wq.w", "attn.wq.b", "attn.wk.w",
              "attn.wk.b", "attn.wv.w", "attn.wv.b", "attn.wo.w",
              "ln2.scale", "ffn.gate.w", "ffn.up.w", "ffn.down.w")


def layer_weights(W: Weights, layer: int) -> Dict[str, torch.Tensor]:
    return {k: layer_weight(W, "blocks." + k, layer) for k in BLOCK_KEYS
            if "blocks." + k in W}


def hidden(W: Weights, cfg: dict, tokens: torch.Tensor,
           prec: Precision = FP32) -> torch.Tensor:
    """The final normed hiddens [B, S, d] of tokens [B, S]."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = prec.act(layer_weight(W, "embed.table", -1)[tokens])
    for i in range(cfg["num_hidden_layers"]):
        x = block(x, layer_weights(W, i), cfg, positions, prec)
    return prec.act(rmsnorm(x, layer_weight(W, "ln_f.scale", -1),
                            cfg["rms_norm_eps"]))


def head(W: Weights, x: torch.Tensor, prec: Precision = FP32
         ) -> torch.Tensor:
    """fp32 logits of hiddens x [..., d]."""
    return torch.matmul(prec.act(x), prec.weight(layer_weight(W, "head.w",
                                                                -1)))
