"""RWKV6-7B (Finch): the attention-free decoder LM (the reference's
``models/rwkv_model.py``).

The decode state is O(1) per layer: the time and channel mixes' carried
last inputs ``tm_prev``/``cm_prev`` and the P x P wkv state per head. There
is no KV cache, so decode ignores the position, the slot windows and the
page tables; a fresh slot's lanes are zeroed by the caller's wipe.

The reference scanned one layer over stacked parameters; here the layers
are an ``nn.ModuleList`` and the scan is a loop over it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.emit import DeviceLike, resolve_device
from repro_torch.dist.sharding import ParamSpec, serving, shard_act
from repro_torch.dist.staging import layers, materialized
from repro_torch.layers.embedding import embed
from repro_torch.layers.linear import matmul_f32
from repro_torch.layers.norm import layernorm
from repro_torch.layers.remat import remat
from repro_torch.layers.rwkv import rwkv6_channel_mix, rwkv6_time_mix
from repro_torch.models.base import (
    ArchConfig,
    PageView,
    PortedLM,
    lm_loss_chunked,
)
from repro_torch.models.blocks import empty_param, linear_params


def layernorm_params(d: int, *, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": empty_param(d, device=device,
                                                  dtype=dtype),
                             "bias": empty_param(d, device=device,
                                                 dtype=dtype)})


class RWKV6Params(nn.Module):
    """One layer's time and channel mix parameters, named as in the
    reference's tree (``mu_{r,k,v,w,g}``, ``wr``/``wk``/``wv``/``wg``/``wo``
    linears, ``w0``, the decay LoRA ``w_lora_a``/``w_lora_b``, ``u``,
    ``ln_x_scale``/``ln_x_bias``; ``mu_ck``/``mu_cr`` and the ``ck``,
    ``cv``, ``cr`` linears). Indexing by name gives the mapping
    ``layers.rwkv`` reads."""

    def __init__(self, d_model: int, d_ff: int, *, head_dim: int,
                 device, dtype, decay_lora: int = 64):
        super().__init__()
        H = d_model // head_dim
        kw = dict(device=device, dtype=dtype)
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "mu_ck",
                     "mu_cr"):
            setattr(self, name, empty_param(d_model, **kw))
        for name in ("wr", "wk", "wv", "wg", "wo", "cr"):
            setattr(self, name, linear_params(d_model, d_model, **kw))
        self.w_lora_a = linear_params(d_model, decay_lora, **kw)
        self.w_lora_b = linear_params(decay_lora, d_model, **kw)
        for name in ("u", "ln_x_scale", "ln_x_bias"):
            setattr(self, name, empty_param(H, head_dim, **kw))
        self.ck = linear_params(d_model, d_ff, **kw)
        self.cv = linear_params(d_ff, d_model, **kw)

    def __getitem__(self, name: str):
        return getattr(self, name)


class RWKVLayer(nn.Module):
    """``x + time_mix(ln1(x))``, then ``x + channel_mix(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, head_dim: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = layernorm_params(cfg.d_model, **kw)
        self.ln2 = layernorm_params(cfg.d_model, **kw)
        self.mix = RWKV6Params(cfg.d_model, cfg.d_ff, head_dim=head_dim, **kw)


class RWKVModel(PortedLM, nn.Module):
    """The RWKV6 LM with its parameters, on one device.

    Parameters are allocated uninitialised; fill them with
    ``init_params`` (random, from a seed; see ``models.base.PortedLM``) or
    :func:`repro_torch.bridge.rwkv_from_arrays` (the reference's arrays).
    It has no ``decode_block``, so no speculative lanes, as in the
    reference, and no dense SwiGLU, so only the LM head is quantized.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"RWKVModel carries the ssm family, not {cfg.family!r}")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.head_dim = cfg.ssm_head_dim or 64
        self.n_heads = cfg.d_model // self.head_dim
        self.embed = nn.ParameterDict({"table": nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw), requires_grad=False)})
        self.ln0 = layernorm_params(cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            [RWKVLayer(cfg, self.head_dim, **kw)
             for _ in range(cfg.n_layers)])
        self.ln_f = layernorm_params(cfg.d_model, **kw)
        self.head = nn.ParameterDict({"w": nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, **kw), requires_grad=False)})

    # -- prefill --------------------------------------------------------------

    def _layer(self, x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
        with materialized(layer):
            x = x + rwkv6_time_mix(layer.mix, layernorm(layer.ln1, x),
                                   head_dim=self.head_dim)
            x = x + rwkv6_channel_mix(layer.mix, layernorm(layer.ln2, x))
        return shard_act(x, "batch", "seq", "act_embed")

    def backbone(self, tokens: torch.Tensor) -> torch.Tensor:
        """The normed hiddens [B, S, d] of ``tokens`` [B, S]; each layer is
        checkpointed under ``cfg.remat`` while autograd records."""
        x = layernorm(self.ln0, embed(self.embed, tokens))
        for layer in self.blocks:
            x = remat(self._layer, x, layer, enabled=self.cfg.remat)
        return layernorm(self.ln_f, x)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training objective (fp32 scalar): the mean next-token
        cross-entropy of ``batch["tokens"]`` against ``batch["labels"]``
        (autograd records through it)."""
        return lm_loss_chunked(self.head["w"],
                               self.backbone(batch["tokens"]),
                               batch["labels"])

    @serving
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill entry point: fp32 logits [B, S, V] for ``batch["tokens"]``
        [B, S]."""
        return shard_act(matmul_f32(self.backbone(batch["tokens"]),
                                    self.head["w"]), "batch", "seq", "vocab")

    # -- decode (O(1) state, no KV cache) -------------------------------------

    def decode_state_specs(self, batch: int, max_len: int
                           ) -> Dict[str, ParamSpec]:
        """The reference's ``decode_state_specs``: ``tm_prev`` and
        ``cm_prev`` [L, B, D] bf16, ``wkv`` [L, B, H, P, P] fp32."""
        L, D = self.cfg.n_layers, self.cfg.d_model
        H, P = self.n_heads, self.head_dim
        prev = ParamSpec((L, batch, D), ("layers", "batch", None),
                         torch.bfloat16, "zeros")
        return {
            "tm_prev": prev,
            "cm_prev": prev,
            "wkv": ParamSpec((L, batch, H, P, P),
                             ("layers", "batch", "act_heads", None, None),
                             torch.float32, "zeros"),
        }

    def decode_state(self, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     only: Optional[str] = None,
                     draft_layers: int = 0) -> Dict[str, torch.Tensor]:
        """A zeroed decode state on the model's device (the reference's
        ``decode_state_specs``, allocated): ``tm_prev`` and ``cm_prev``
        [L, B, D] in bf16, ``wkv`` [L, B, H, P, P] in fp32. ``max_len`` is
        unused: the state does not grow with the sequence.

        Every leaf is per slot, so with ``paged`` the pool half (``only=
        "pool"``) is empty and the dense half is the whole state. The
        model has no speculative draft, so ``draft_layers`` must be 0."""
        if draft_layers:
            raise ValueError("the ssm family has no block-verify decode "
                             "path (decode_block), so no draft state")
        if paged is not None and only == "pool":
            return {}
        L, D = self.cfg.n_layers, self.cfg.d_model
        H, P = self.n_heads, self.head_dim
        kw = dict(device=self.device)
        return {
            "tm_prev": torch.zeros((L, batch, D), dtype=torch.bfloat16, **kw),
            "cm_prev": torch.zeros((L, batch, D), dtype=torch.bfloat16, **kw),
            "wkv": torch.zeros((L, batch, H, P, P), dtype=torch.float32, **kw),
        }

    @serving
    def decode_step(self, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, *,
                    window_start: Optional[torch.Tensor] = None,
                    pages: Optional[PageView] = None):
        """One token for every sequence: tokens [B] int. Writes every leaf
        of ``state`` in place (the carried inputs rounded to the state's
        dtype: bf16, as the reference stores them) and returns ``(logits
        [B, V] fp32, state)``. The recurrence is position-free and has no KV cache, so
        ``pos``, ``window_start`` and ``pages`` are unused."""
        del pos, window_start, pages
        tm, cm, wkv = state["tm_prev"], state["cm_prev"], state["wkv"]
        x = layernorm(self.ln0, embed(self.embed, tokens[:, None]))
        for i, layer in enumerate(self.blocks):
            with layers(i, tm, cm, wkv) as (tm_i, cm_i, wkv_i), \
                    materialized(layer):
                o, tm_new, s = rwkv6_time_mix(
                    layer.mix, layernorm(layer.ln1, x),
                    head_dim=self.head_dim, tm_prev=tm_i, wkv_state=wkv_i,
                    return_state=True)
                x = x + o
                o, cm_new = rwkv6_channel_mix(
                    layer.mix, layernorm(layer.ln2, x), cm_prev=cm_i,
                    return_state=True)
                x = x + o
                tm_i.copy_(tm_new)      # rounded to the state's dtype
                cm_i.copy_(cm_new)
                wkv_i.copy_(s)
        return self.head_logits(layernorm(self.ln_f, x)), state
