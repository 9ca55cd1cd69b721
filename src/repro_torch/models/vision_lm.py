"""Llama-3.2-Vision-90B-class model: a decoder LM with interleaved gated
cross-attention layers over precomputed vision patch embeddings.

100 layers = 20 superblocks x (4 self-attention + 1 gated
cross-attention). The vision frontend is a stub, as in the reference: a
prefill takes patch embeddings ``vision`` [B, n_image_tokens, d_model].

The reference scanned superblocks over ``self_blocks`` stacked
``[n_super, self_per_block, ...]`` and ``cross_blocks`` stacked
``[n_super, ...]``; here they are a nested ``nn.ModuleList``
``[superblock][layer]`` and a flat one, and the scans are loops. The
decode state flattens the reference's ``[n_super, self_per_block, B,
...]`` KV caches to ``[n_super * self_per_block, B, ...]`` (layer ``s *
self_per_block + e``), so every batch-laned leaf has its batch on axis 1,
as the wipe and the state pool expect. Nothing in serving fills the cross
caches: as in the reference, a served stream attends over zero memory
(:meth:`VisionLM.init_cross_cache` makes them from patch embeddings).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.emit import DeviceLike, resolve_device
from repro_torch.dist.sharding import ParamSpec, reshape, serving, shard_act
from repro_torch.layers.embedding import embed
from repro_torch.layers.linear import linear, matmul_f32
from repro_torch.layers.norm import rmsnorm
from repro_torch.layers.remat import remat
from repro_torch.models.base import (
    CROSS_STATE_KEYS,
    PAGED_STATE_KEYS,
    ArchConfig,
    PageView,
    PortedLM,
    lm_loss_chunked,
)
from repro_torch.models.blocks import AttnBlock, CrossBlock, norm_params


class VisionLM(PortedLM, nn.Module):
    """The vision LM with its parameters, on one device.

    Parameters are allocated uninitialised; fill them with
    ``init_params`` (random, from a seed; see ``models.base.PortedLM``) or
    :func:`repro_torch.bridge.vlm_from_arrays` (the reference's arrays).
    On a quantized plan only the self blocks' SwiGLU down-projections run
    a16w8 through qmatmul; the cross blocks' SwiGLU and the decode head
    stay float, as in the reference. It has no ``decode_block``, so no
    speculative lanes.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family != "vlm":
            raise NotImplementedError(
                f"VisionLM carries the vlm family, not {cfg.family!r}")
        if not (cfg.cross_attn_every > 1
                and cfg.n_layers % cfg.cross_attn_every == 0):
            raise ValueError(f"{cfg.n_layers} layers do not split into "
                             f"superblocks of cross_attn_every="
                             f"{cfg.cross_attn_every}")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.self_per_block = cfg.cross_attn_every - 1
        self.n_super = cfg.n_layers // cfg.cross_attn_every
        self.embed = nn.ParameterDict({"table": nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw), requires_grad=False)})
        self.self_blocks = nn.ModuleList([
            nn.ModuleList([AttnBlock(cfg, **kw)
                           for _ in range(self.self_per_block)])
            for _ in range(self.n_super)])
        self.cross_blocks = nn.ModuleList(
            [CrossBlock(cfg, **kw) for _ in range(self.n_super)])
        self.ln_f = norm_params(cfg.d_model, **kw)
        self.head = nn.ParameterDict({"w": nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, **kw), requires_grad=False)})

    def ffn_blocks(self):
        return [blk for group in self.self_blocks for blk in group]

    def mlp_down_weights(self):
        """Every ``ffn.down`` weight, the cross blocks' too: the
        reference's calibration takes ``w_shift`` over all of them,
        although only the self blocks' are quantized."""
        return super().mlp_down_weights() + [
            blk.ffn["down"]["w"] for blk in self.cross_blocks]

    # -- prefill --------------------------------------------------------------

    def backbone(self, tokens: torch.Tensor,
                 vision: torch.Tensor) -> torch.Tensor:
        """The normed hiddens [B, S, d] of ``tokens`` [B, S] over the patch
        embeddings ``vision`` [B, M, d]; each superblock is checkpointed
        under ``cfg.remat`` while autograd records."""
        B, S = tokens.shape
        x = embed(self.embed, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        vision = shard_act(vision, "batch", "seq", "act_embed")
        for group, cross in zip(self.self_blocks, self.cross_blocks):
            x = remat(self._superblock, x, group, cross, positions, vision,
                      enabled=self.cfg.remat)
        return rmsnorm(self.ln_f, x)

    def _superblock(self, x: torch.Tensor, group: nn.ModuleList,
                    cross: CrossBlock, positions: torch.Tensor,
                    vision: torch.Tensor) -> torch.Tensor:
        for blk in group:
            x, _ = blk(x, positions, self.cfg)
        return cross(x, vision, self.cfg)

    @serving
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill entry point: fp32 logits [B, S, V] for ``batch["tokens"]``
        [B, S] over ``batch["vision"]`` [B, M, d]."""
        x = self.backbone(batch["tokens"], batch["vision"])
        return shard_act(matmul_f32(x, self.head["w"]), "batch", "seq",
                         "vocab")

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training objective (fp32 scalar): the mean next-token
        cross-entropy of ``batch["tokens"]`` against ``batch["labels"]``
        over ``batch["vision"]`` (autograd records through it)."""
        x = self.backbone(batch["tokens"], batch["vision"])
        return lm_loss_chunked(self.head["w"], x, batch["labels"])

    # -- decode ---------------------------------------------------------------

    def decode_state_specs(self, batch: int, max_len: int
                           ) -> Dict[str, ParamSpec]:
        """The reference's ``decode_state_specs``, in its layout: the bf16
        KV caches [n_super, self_per_block, B, max_len, KV, hd] (the port's
        leaves flatten the two stacked dims; ``models.base.port_layout``)
        and cross caches [n_super, B, n_image_tokens, KV, hd]."""
        cfg = self.cfg
        kv = ParamSpec((self.n_super, self.self_per_block, batch, max_len,
                        cfg.n_kv, cfg.head_dim),
                       ("layers", "layers", "batch", "seq", "cache_heads",
                        "cache_hd"), torch.bfloat16, "zeros")
        xkv = ParamSpec((self.n_super, batch, cfg.n_image_tokens, cfg.n_kv,
                         cfg.head_dim),
                        ("layers", "batch", "seq", "cache_heads",
                         "cache_hd"), torch.bfloat16, "zeros")
        return {"cache_k": kv, "cache_v": kv, "cross_k": xkv, "cross_v": xkv}

    def decode_state(self, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     only: Optional[str] = None,
                     draft_layers: int = 0) -> Dict[str, torch.Tensor]:
        """A zeroed bf16 decode state on the model's device (the
        reference's ``decode_state_specs``, allocated): ``cache_k`` and
        ``cache_v`` [n_super * self_per_block, B, max_len, KV, hd] and
        ``cross_k``/``cross_v`` [n_super, B, n_image_tokens, KV, hd].

        With ``paged=(page_count, page_size)`` the self-attention caches
        are the shared page pool [n_super * self_per_block, page_count,
        page_size, KV, hd] and the cross caches stay per slot; ``only``
        picks one half of a paged state: ``"pool"`` the pool leaves,
        ``"dense"`` the cross caches. The model has no speculative draft,
        so ``draft_layers`` must be 0."""
        if draft_layers:
            raise ValueError("the vlm family has no block-verify decode "
                             "path (decode_block), so no draft state")
        cfg = self.cfg
        shapes = {}
        if not (paged is not None and only == "pool"):
            shapes.update({name: (self.n_super, batch, cfg.n_image_tokens)
                           for name in CROSS_STATE_KEYS})
        if not (paged is not None and only == "dense"):
            per_slot = (batch, max_len) if paged is None else tuple(paged)
            shapes.update({name: (self.n_super * self.self_per_block,
                                  *per_slot)
                           for name in PAGED_STATE_KEYS})
        return {name: torch.zeros((*s, cfg.n_kv, cfg.head_dim),
                                  dtype=torch.bfloat16, device=self.device)
                for name, s in shapes.items()}

    @serving
    def init_cross_cache(self, vision: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every superblock's cross-attention keys and values of the patch
        embeddings ``vision`` [B, M, d]: ``(k, v)``, each [n_super, B, M,
        KV, hd] in ``vision``'s dtype, the decode state's ``cross_k`` and
        ``cross_v``."""
        cfg = self.cfg
        B, M, _ = vision.shape

        def project(w):
            return torch.stack([
                reshape(linear(blk.xattn[w], vision), B, M, cfg.n_kv,
                        cfg.head_dim)
                for blk in self.cross_blocks])

        return project("wk"), project("wv")

    @serving
    def decode_step(self, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, *,
                    window_start: Optional[torch.Tensor] = None,
                    pages: Optional[PageView] = None):
        """One token for every sequence: tokens [B] int, ``pos`` the
        position of the new token. Writes the KV caches of ``state`` in
        place and returns ``(logits [B, V] fp32, state)``; the cross
        caches are read only. ``window_start`` and ``pages`` reach the
        self blocks as in ``DecoderLM.decode_step``. The head is the float
        product whatever ``cfg.quantized`` says, as in the reference."""
        cfg = self.cfg
        x = embed(self.embed, tokens[:, None])
        for s, (group, cross) in enumerate(zip(self.self_blocks,
                                               self.cross_blocks)):
            for e, blk in enumerate(group):
                i = s * self.self_per_block + e
                x, _, _ = blk.decode(
                    x, state["cache_k"][i], state["cache_v"][i], pos, cfg,
                    window_start=window_start, pages=pages)
            x = cross.decode(x, state["cross_k"][s], state["cross_v"][s],
                             cfg)
        x = rmsnorm(self.ln_f, x)
        return matmul_f32(x, self.head["w"])[:, 0], state
