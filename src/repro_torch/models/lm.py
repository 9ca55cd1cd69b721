"""Decoder-only LM, dense GQA or MoE (yi-6b, qwen1.5-4b, qwen1.5-110b,
mistral-large-123b, phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b).

The reference scanned one block over stacked layer parameters; here the
blocks are an ``nn.ModuleList`` and the scan is a loop over it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.emit import DeviceLike, resolve_device
from repro_torch.dist.sharding import ParamSpec, serving, shard_act
from repro_torch.layers.embedding import embed
from repro_torch.layers.linear import matmul_f32
from repro_torch.layers.norm import rmsnorm
from repro_torch.layers.remat import remat
from repro_torch.models.base import (
    DRAFT_PREFIX,
    PAGED_STATE_KEYS,
    ArchConfig,
    PageView,
    PortedLM,
    lm_loss_chunked,
)
from repro_torch.models.blocks import AttnBlock, norm_params


class DecoderLM(PortedLM, nn.Module):
    """The decoder LM (dense or MoE) with its parameters, on one device.

    Parameters are allocated uninitialised; fill them with
    ``init_params`` (random, from a seed; see ``models.base.PortedLM``) or
    :func:`repro_torch.bridge.decoder_lm_from_arrays` (the reference's
    arrays). ``cfg`` may be replaced after construction (the plan
    recalibrates the quantization shifts); the parameters do not depend
    on it beyond their shapes.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"DecoderLM carries the dense and moe families, not "
                f"{cfg.family!r}")
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

    def ffn_blocks(self):
        return [] if self.cfg.family == "moe" else list(self.blocks)

    # -- prefill --------------------------------------------------------------

    def backbone(self, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The normed hiddens [B, S, d] of ``tokens`` [B, S], and the MoE
        aux load-balance loss summed over the layers (zero when dense)."""
        B, S = tokens.shape
        x = embed(self.embed, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for blk in self.blocks:
            x, a = remat(blk, x, positions, self.cfg, enabled=self.cfg.remat)
            if a is not None:
                aux = aux + a
        return rmsnorm(self.ln_f, x), aux

    @serving
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill entry point: fp32 logits [B, S, V] for ``batch["tokens"]``
        [B, S]."""
        x, _ = self.backbone(batch["tokens"])
        return shard_act(matmul_f32(x, self.head["w"]), "batch", "seq",
                         "vocab")

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training objective (fp32 scalar): the mean next-token
        cross-entropy of ``batch["tokens"]`` [B, S] against
        ``batch["labels"]`` [B, S], plus 0.01 times the MoE aux loss. Not
        under inference mode: autograd records through it, each block
        checkpointed under ``cfg.remat``."""
        x, aux = self.backbone(batch["tokens"])
        return lm_loss_chunked(self.head["w"], x, batch["labels"]) \
            + 0.01 * aux

    # -- decode ---------------------------------------------------------------

    def decode_state_specs(self, batch: int, max_len: int
                           ) -> Dict[str, ParamSpec]:
        """The reference's ``decode_state_specs``: the bf16 KV cache
        [L, B, max_len, KV, hd] by state key, with its logical axes."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
        axes = ("layers", "batch", "seq", "cache_heads", "cache_hd")
        return {name: ParamSpec(shape, axes, torch.bfloat16, "zeros")
                for name in PAGED_STATE_KEYS}

    def decode_state(self, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     only: Optional[str] = None,
                     draft_layers: int = 0) -> Dict[str, torch.Tensor]:
        """A zeroed bf16 KV cache ``{"cache_k", "cache_v"}``, each
        [L, B, max_len, KV, hd] on the model's device (the reference's
        ``decode_state_specs``, allocated).

        With ``paged=(page_count, page_size)`` the leaves are the shared
        page pool [L, page_count, page_size, KV, hd] instead. ``only``
        picks one half of a paged state: ``"pool"`` the pool leaves,
        ``"dense"`` the per-slot remainder (empty for this model, whose
        only state is the KV cache). ``draft_layers`` N > 0 adds the
        speculative draft's KV twins ``draft_cache_k``/``draft_cache_v``
        with N layers, laid out like the target's (the reference's
        ``spec_state_specs``)."""
        cfg = self.cfg
        per_slot = (batch, max_len)
        if paged is not None:
            per_slot = tuple(paged)
        layers = {name: cfg.n_layers for name in PAGED_STATE_KEYS}
        if draft_layers:
            layers.update({DRAFT_PREFIX + name: draft_layers
                           for name in PAGED_STATE_KEYS})
        if paged is not None and only == "dense":
            layers = {}
        return {name: torch.zeros((n, *per_slot, cfg.n_kv, cfg.head_dim),
                                  dtype=torch.bfloat16, device=self.device)
                for name, n in layers.items()}

    @serving
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
        return self.head_logits(rmsnorm(self.ln_f, x)), state

    @serving
    def decode_block(self, state: Dict[str, torch.Tensor],
                     tokens: torch.Tensor, local: torch.Tensor, *,
                     pages: Optional[PageView] = None,
                     n_layers: Optional[int] = None):
        """Score a block of m consecutive tokens per sequence in one pass.

        ``tokens`` [B, m] int; ``local`` [B] int is each slot's local
        position of ``tokens[:, 0]`` (RoPE, cache writes and the per-query
        mask all use ``local[b] + j``). With ``pages`` (whose ``local_pos``
        equals ``local``) the KV leaves are the shared page pool. The KV
        of ``state`` is written in place. ``n_layers`` N runs only the
        first N blocks with the shared embedding, final norm and head: the
        self-speculative draft, on the draft half of a speculative state
        (``split_spec_state``), whose leaves have N layers.

        Returns ``(logits [B, m, V] fp32, state)``: ``logits[b, j]`` is the
        next-token distribution after ``tokens[b, :j + 1]``, what m
        ``decode_step`` calls give up to float re-association. ``m == 1``
        is the draft's step, ``m == k`` the target's verify pass.
        """
        cfg = self.cfg
        n = cfg.n_layers if n_layers is None else n_layers
        if state["cache_k"].shape[0] != n:
            raise ValueError(f"state has {state['cache_k'].shape[0]} layers, "
                             f"the block runs {n}")
        x = embed(self.embed, tokens)
        for i, blk in enumerate(self.blocks[:n]):
            x, _, _ = blk.decode(x, state["cache_k"][i], state["cache_v"][i],
                                 None, cfg, pages=pages, local=local)
        return self.head_logits(rmsnorm(self.ln_f, x), block=True), state
