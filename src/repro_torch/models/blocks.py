"""The pre-norm residual transformer blocks: the decoder LMs' GQA
attention, then a dense SwiGLU FFN or a mixture of experts; and the vision
LM's gated cross-attention block. Also the parameter helpers every model
of the port builds its tree with."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.dist.sharding import shard_act
from repro_torch.layers.attention import (
    block_decode_self_attention,
    cross_attention,
    decode_cross_attention,
    decode_self_attention,
    paged_block_decode_self_attention,
    paged_decode_self_attention,
    self_attention,
)
from repro_torch.layers.linear import quantize_weight
from repro_torch.layers.mlp import swiglu
from repro_torch.layers.moe import moe
from repro_torch.layers.norm import rmsnorm
from repro_torch.models.base import ArchConfig


def empty_param(*shape: int, device, dtype) -> nn.Parameter:
    """An uninitialised parameter that takes no gradient."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def linear_params(d_in: int, d_out: int, *, bias: bool = False, device,
                  dtype) -> nn.ParameterDict:
    """One linear's parameters: ``w`` (d_in, d_out) and optionally ``b``."""
    p = {"w": empty_param(d_in, d_out, device=device, dtype=dtype)}
    if bias:
        p["b"] = empty_param(d_out, device=device, dtype=dtype)
    return nn.ParameterDict(p)


def norm_params(d: int, *, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": empty_param(d, device=device,
                                                  dtype=dtype)})


def layernorm_params(d: int, *, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": empty_param(d, device=device, dtype=dtype),
        "bias": empty_param(d, device=device, dtype=dtype)})


def attention_params(cfg: ArchConfig, *, qkv_bias: bool = False,
                     device, dtype) -> nn.ModuleDict:
    """``wq``, ``wk``, ``wv`` (biased with ``qkv_bias``) and ``wo`` of a
    GQA attention at ``cfg``'s widths; the keys and values of a
    cross-attention project the memory, which has width d_model too."""
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    return nn.ModuleDict({
        "wq": linear_params(d, cfg.n_heads * hd, bias=qkv_bias, **kw),
        "wk": linear_params(d, cfg.n_kv * hd, bias=qkv_bias, **kw),
        "wv": linear_params(d, cfg.n_kv * hd, bias=qkv_bias, **kw),
        "wo": linear_params(cfg.n_heads * hd, d, **kw),
    })


def mlp_params(d: int, d_ff: int, *, device, dtype) -> nn.ModuleDict:
    """The GELU MLP's ``up`` and ``down``, each with a bias."""
    return nn.ModuleDict({
        "up": linear_params(d, d_ff, bias=True, device=device, dtype=dtype),
        "down": linear_params(d_ff, d, bias=True, device=device,
                              dtype=dtype),
    })


def swiglu_params(d: int, d_ff: int, *, device, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "gate": linear_params(d, d_ff, device=device, dtype=dtype),
        "up": linear_params(d, d_ff, device=device, dtype=dtype),
        "down": linear_params(d_ff, d, device=device, dtype=dtype),
    })


class AttnBlock(nn.Module):
    """GQA self-attention then a SwiGLU FFN, each behind an RMS norm and a
    residual. Parameter names follow the reference's tree (``ln1``,
    ``attn.{wq,wk,wv,wo}``, ``ln2``, ``ffn.{gate,up,down}``).

    In the MoE family (``cfg.family == "moe"``) the FFN is a mixture of
    experts instead: ``moe.router`` [d, E] and ``moe.{w_gate,w_up}`` [E,
    d, f], ``moe.w_down`` [E, f, d] with f = ``moe_d_ff``, plus, with
    ``n_shared_experts``, a SwiGLU ``shared`` of width ``n_shared_experts
    * moe_d_ff`` that every token runs. Only the dense ``ffn`` has the
    quantized (a16w8) down-projection, as in the reference."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.ln1 = norm_params(d, **kw)
        self.attn = attention_params(cfg, qkv_bias=cfg.qkv_bias, **kw)
        self.ln2 = norm_params(d, **kw)
        self.use_moe = cfg.family == "moe"
        if self.use_moe:
            E, f = cfg.n_experts, cfg.moe_d_ff
            self.moe = nn.ParameterDict({
                "router": empty_param(d, E, **kw),
                "w_gate": empty_param(E, d, f, **kw),
                "w_up": empty_param(E, d, f, **kw),
                "w_down": empty_param(E, f, d, **kw),
            })
            self.shared = (swiglu_params(d, cfg.n_shared_experts * f, **kw)
                           if cfg.n_shared_experts else None)
        else:
            self.ffn = swiglu_params(d, cfg.d_ff, **kw)
        self._down_q: Optional[Tuple[int, torch.Tensor]] = None

    def quantized_down(self, w_shift: int) -> torch.Tensor:
        """The down-projection weight as int8 at ``w_shift``, made once.

        The parameters are fixed after loading (``DecoderLM`` drops this
        copy whenever it loads weights), so this is the same bits as
        quantizing on every call.
        """
        if self._down_q is None or self._down_q[0] != w_shift:
            self._down_q = (w_shift,
                            quantize_weight(self.ffn["down"]["w"], w_shift))
        return self._down_q[1]

    def ffn_part(self, x: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The FFN of normed x: ``(y, MoE aux loss)``, the aux None for the
        dense FFN."""
        if self.use_moe:
            y, aux = moe(self.moe, x, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, n_groups=cfg.moe_groups or 1)
            if self.shared is not None:
                y = y + swiglu(self.shared, x)
            return y, aux
        if not cfg.quantized_mlp:
            return swiglu(self.ffn, x), None
        quant = (cfg.mlp_x_shift, cfg.mlp_w_shift, cfg.mlp_out_shift)
        return swiglu(self.ffn, x, quant=quant,
                      down_wq=self.quantized_down(cfg.mlp_w_shift)), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Prefill of x [B, S, d]: ``(x, MoE aux loss or None)``."""
        h = rmsnorm(self.ln1, x)
        h = self_attention(
            self.attn, h, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
        )
        x = shard_act(x + h, "batch", "seq", "act_embed")
        h, aux = self.ffn_part(rmsnorm(self.ln2, x), cfg)
        return shard_act(x + h, "batch", "seq", "act_embed"), aux

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: Optional[int], cfg: ArchConfig, *,
               window_start: Optional[torch.Tensor] = None, pages=None,
               local: Optional[torch.Tensor] = None):
        """One decode token; writes this layer's caches in place. With
        ``pages`` (a ``models.base.PageView``) the caches are this layer's
        page pool [P, ps, KV, hd] and ``pos``/``window_start`` are unused:
        each slot indexes and rotates at its own local position.

        With ``local`` ([B] int) ``x`` is a block [B, m, d] decoded at each
        slot's local positions ``local[b] + j`` (the speculative lanes);
        paged, the PageView's ``local_pos`` is the block's origin and
        ``local`` only selects the block path."""
        h = rmsnorm(self.ln1, x)
        heads = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                     head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        if local is not None and pages is not None:
            h, ck, cv = paged_block_decode_self_attention(
                self.attn, h, cache_k, cache_v, pages, **heads)
        elif local is not None:
            h, ck, cv = block_decode_self_attention(
                self.attn, h, cache_k, cache_v, local, **heads)
        elif pages is not None:
            h, ck, cv = paged_decode_self_attention(
                self.attn, h, cache_k, cache_v, pages, **heads)
        else:
            h, ck, cv = decode_self_attention(
                self.attn, h, cache_k, cache_v, pos,
                window_start=window_start, **heads)
        x = x + h
        h, _ = self.ffn_part(rmsnorm(self.ln2, x), cfg)
        return x + h, ck, cv


class CrossBlock(nn.Module):
    """The vision LM's gated cross-attention block over a memory (the
    patch embeddings): ``x + tanh(gate) * xattn(rmsnorm(x), memory)``, then
    ``+ swiglu(rmsnorm(.))``. Parameter names follow the reference's tree
    (``ln1``, ``xattn.{wq,wk,wv,wo}``, ``ln2``, ``ffn.{gate,up,down}``,
    ``gate`` [1]); the gate starts at zero, so a fresh block adds only its
    FFN. Its SwiGLU always runs float, as in the reference, even on a
    quantized plan."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = norm_params(cfg.d_model, **kw)
        self.xattn = attention_params(cfg, **kw)
        self.ln2 = norm_params(cfg.d_model, **kw)
        self.ffn = swiglu_params(cfg.d_model, cfg.d_ff, **kw)
        self.gate = empty_param(1, **kw)

    def _gated(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gate = torch.tanh(self.gate.float()).to(x.dtype)
        x = x + gate * h
        return x + swiglu(self.ffn, rmsnorm(self.ln2, x))

    def forward(self, x: torch.Tensor, memory: torch.Tensor, cfg: ArchConfig,
                memory_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill of x [B, S, d] over ``memory`` [B, M, d]."""
        h = cross_attention(
            self.xattn, rmsnorm(self.ln1, x), memory,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            memory_valid=memory_valid, q_chunk=cfg.q_chunk,
        )
        return shard_act(self._gated(x, h), "batch", "seq", "act_embed")

    def decode(self, x: torch.Tensor, cross_k: torch.Tensor,
               cross_v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        """One decode token x [B, 1, d] over the memory's precomputed keys
        and values [B, M, KV, hd] (``VisionLM.init_cross_cache``)."""
        h = decode_cross_attention(
            self.xattn, rmsnorm(self.ln1, x), cross_k, cross_v,
            n_heads=cfg.n_heads, head_dim=cfg.head_dim)
        return self._gated(x, h)
