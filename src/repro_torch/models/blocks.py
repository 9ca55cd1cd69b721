"""The pre-norm residual transformer block of the dense decoder LM."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.layers.attention import decode_self_attention, self_attention
from repro_torch.layers.linear import quantize_weight
from repro_torch.layers.mlp import swiglu
from repro_torch.layers.norm import rmsnorm
from repro_torch.models.base import ArchConfig


def _param(*shape: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def linear_params(d_in: int, d_out: int, *, bias: bool = False, device,
                  dtype) -> nn.ParameterDict:
    """One linear's parameters: ``w`` (d_in, d_out) and optionally ``b``."""
    p = {"w": _param(d_in, d_out, device=device, dtype=dtype)}
    if bias:
        p["b"] = _param(d_out, device=device, dtype=dtype)
    return nn.ParameterDict(p)


def norm_params(d: int, *, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _param(d, device=device, dtype=dtype)})


class AttnBlock(nn.Module):
    """GQA self-attention then a SwiGLU FFN, each behind an RMS norm and a
    residual. Parameter names follow the reference's tree (``ln1``,
    ``attn.{wq,wk,wv,wo}``, ``ln2``, ``ffn.{gate,up,down}``)."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.ln1 = norm_params(d, **kw)
        self.attn = nn.ModuleDict({
            "wq": linear_params(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
            "wk": linear_params(d, cfg.n_kv * hd, bias=cfg.qkv_bias, **kw),
            "wv": linear_params(d, cfg.n_kv * hd, bias=cfg.qkv_bias, **kw),
            "wo": linear_params(cfg.n_heads * hd, d, **kw),
        })
        self.ln2 = norm_params(d, **kw)
        self.ffn = nn.ModuleDict({
            "gate": linear_params(d, cfg.d_ff, **kw),
            "up": linear_params(d, cfg.d_ff, **kw),
            "down": linear_params(cfg.d_ff, d, **kw),
        })
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

    def ffn_part(self, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        if not cfg.quantized_mlp:
            return swiglu(self.ffn, x)
        quant = (cfg.mlp_x_shift, cfg.mlp_w_shift, cfg.mlp_out_shift)
        return swiglu(self.ffn, x, quant=quant,
                      down_wq=self.quantized_down(cfg.mlp_w_shift))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
        h = rmsnorm(self.ln1, x)
        h = self_attention(
            self.attn, h, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
        )
        x = x + h
        return x + self.ffn_part(rmsnorm(self.ln2, x), cfg)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int, cfg: ArchConfig, *,
               window_start: Optional[torch.Tensor] = None):
        """One decode token; writes this layer's caches in place."""
        h = rmsnorm(self.ln1, x)
        h, ck, cv = decode_self_attention(
            self.attn, h, cache_k, cache_v, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window_start=window_start,
        )
        x = x + h
        return x + self.ffn_part(rmsnorm(self.ln2, x), cfg), ck, cv
