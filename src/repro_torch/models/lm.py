"""Decoder-only LM, dense GQA (yi-6b and its kin).

The reference scanned one block over stacked layer parameters; here the
blocks are an ``nn.ModuleList`` and the scan is a loop over it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.emit import DeviceLike, resolve_device
from repro_torch.layers.embedding import embed
from repro_torch.layers.linear import matmul_f32, quantize_weight
from repro_torch.layers.norm import rmsnorm
from repro_torch.models.base import (
    HEAD_SHIFTS,
    PAGED_STATE_KEYS,
    ArchConfig,
    PageView,
    decode_head_logits,
)
from repro_torch.models.blocks import AttnBlock, norm_params


class DecoderLM(nn.Module):
    """The dense decoder LM with its parameters, on one device.

    Parameters are allocated uninitialised; fill them with
    :meth:`init_params` (random, from a seed) or
    :func:`repro_torch.bridge.decoder_lm_from_arrays` (the reference's
    arrays). ``cfg`` may be replaced after construction (the plan
    recalibrates the quantization shifts); the parameters do not depend
    on it beyond their shapes.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"DecoderLM carries the dense family, not {cfg.family!r} "
                "(ROADMAP Queue 1 item 12)")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.ParameterDict({"table": nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw), requires_grad=False)})
        self.blocks = nn.ModuleList(
            [AttnBlock(cfg, **kw) for _ in range(cfg.n_layers)])
        self.ln_f = norm_params(cfg.d_model, **kw)
        self.head = nn.ParameterDict({"w": nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, **kw), requires_grad=False)})
        self._head_q: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.head["w"].device

    # -- parameters -----------------------------------------------------------

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "DecoderLM":
        """Random parameters from a ``torch.Generator`` on the model's
        device, with the reference's initialisers: norm scales 1, biases
        0, the embedding table N(0, d_model**-0.5), every weight
        N(0, d_in**-0.5). The stream differs from the reference's
        ``jax.random``; tests carry weights across with the bridge."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "b":
                p.zero_()
            else:
                std = (p.shape[-1] if name == "embed.table"
                       else p.shape[0]) ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=self.device) * std)
        self.reset_quantized()
        return self

    def reset_quantized(self) -> None:
        """Drop the int8 weight copies; call after changing parameters."""
        self._head_q = None
        for blk in self.blocks:
            blk._down_q = None

    def quantized_head(self) -> torch.Tensor:
        """The LM head as int8 at the head's w_shift, made once."""
        if self._head_q is None:
            self._head_q = quantize_weight(self.head["w"], HEAD_SHIFTS[1])
        return self._head_q

    # -- prefill --------------------------------------------------------------

    def backbone(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        x = embed(self.embed, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for blk in self.blocks:
            x = blk(x, positions, self.cfg)
        return rmsnorm(self.ln_f, x)

    @torch.inference_mode()
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill entry point: fp32 logits [B, S, V] for ``batch["tokens"]``
        [B, S]."""
        x = self.backbone(batch["tokens"])
        return matmul_f32(x, self.head["w"])

    # -- decode ---------------------------------------------------------------

    def decode_state(self, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     only: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """A zeroed bf16 KV cache ``{"cache_k", "cache_v"}``, each
        [L, B, max_len, KV, hd] on the model's device (the reference's
        ``decode_state_specs``, allocated).

        With ``paged=(page_count, page_size)`` the leaves are the shared
        page pool [L, page_count, page_size, KV, hd] instead. ``only``
        picks one half of a paged state: ``"pool"`` the pool leaves,
        ``"dense"`` the per-slot remainder (empty for this model, whose
        only state is the KV cache)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
        if paged is not None:
            page_count, page_size = paged
            shape = (cfg.n_layers, page_count, page_size, cfg.n_kv,
                     cfg.head_dim)
        names = PAGED_STATE_KEYS
        if paged is not None and only == "dense":
            names = ()
        return {name: torch.zeros(shape, dtype=torch.bfloat16,
                                  device=self.device)
                for name in names}

    @torch.inference_mode()
    def decode_step(self, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, *,
                    window_start: Optional[torch.Tensor] = None,
                    pages: Optional[PageView] = None):
        """One token for every sequence: tokens [B] int, ``pos`` the
        position of the new token. Writes the KV cache of ``state`` in
        place (the reference returned a new state) and returns
        ``(logits [B, V] fp32, state)``. ``window_start`` ([B], optional)
        limits each sequence's attention to cache positions at or after
        its own start. With ``pages`` the KV leaves are the shared page
        pool and each slot indexes and rotates at its own local position
        (``pos`` and ``window_start`` are then unused)."""
        cfg = self.cfg
        x = embed(self.embed, tokens[:, None])
        for i, blk in enumerate(self.blocks):
            x, _, _ = blk.decode(x, state["cache_k"][i], state["cache_v"][i],
                                 pos, cfg, window_start=window_start,
                                 pages=pages)
        x = rmsnorm(self.ln_f, x)
        head_q = self.quantized_head() if cfg.quantized else None
        return decode_head_logits(self.head["w"], x, cfg, head_q), state
