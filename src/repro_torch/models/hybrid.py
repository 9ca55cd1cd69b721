"""Zamba2-2.7B-class hybrid: a Mamba2 backbone and one SHARED attention
block.

54 Mamba2 layers in 9 groups of 6; after each group the same
(weight-shared) attention+SwiGLU block runs, so one block's weights serve
9 call sites. Decode keeps O(1) SSM and conv state per Mamba2 layer and
one KV cache per shared-block call site.

The reference scanned groups and layers over stacked ``[G, E, ...]``
parameters; here ``mamba_blocks`` is a nested ``nn.ModuleList``
``[group][layer]`` with the same tree, and the scans are loops. The decode
state flattens the reference's ``[G, E, B, ...]`` SSM and conv leaves to
``[G * E, B, ...]`` (layer ``g * attn_every + e``), so every batch-laned
leaf has its batch on axis 1, as the wipe and the state pool expect.
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
from repro_torch.layers.ssm import (
    D_CONV,
    mamba2,
    mamba2_decode,
    mamba2_state_spec,
)
from repro_torch.models.base import (
    PAGED_STATE_KEYS,
    ArchConfig,
    PageView,
    PortedLM,
    lm_loss_chunked,
)
from repro_torch.models.blocks import (
    AttnBlock,
    empty_param,
    linear_params,
    norm_params,
)


class Mamba2Params(nn.Module):
    """One Mamba2 mixer's parameters, named as in the reference's tree
    (``wz``, ``wx``, ``wBC``, ``wdt``, ``out`` linears; ``conv_w``,
    ``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``norm_scale``). Indexing
    by name gives the mapping ``layers.ssm`` reads."""

    def __init__(self, d_model: int, *, expand: int, head_dim: int,
                 d_state: int, device, dtype):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        kw = dict(device=device, dtype=dtype)
        self.wz = linear_params(d_model, d_inner, **kw)
        self.wx = linear_params(d_model, d_inner, **kw)
        self.wBC = linear_params(d_model, 2 * d_state, **kw)
        self.wdt = linear_params(d_model, n_heads, **kw)
        self.conv_w = empty_param(D_CONV, d_inner, **kw)
        self.conv_b = empty_param(d_inner, **kw)
        self.dt_bias = empty_param(n_heads, **kw)
        self.A_log = empty_param(n_heads, **kw)
        self.D = empty_param(n_heads, **kw)
        self.norm_scale = empty_param(d_inner, **kw)
        self.out = linear_params(d_inner, d_model, **kw)

    def __getitem__(self, name: str):
        return getattr(self, name)


class MambaLayer(nn.Module):
    """A pre-norm residual Mamba2 layer: ``x + mamba2(rmsnorm(x))``."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        self.ln = norm_params(cfg.d_model, device=device, dtype=dtype)
        self.mamba = Mamba2Params(
            cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            d_state=cfg.ssm_state, device=device, dtype=dtype)


class HybridModel(PortedLM, nn.Module):
    """The hybrid (Mamba2 + one shared attention block) with its
    parameters, on one device.

    Parameters are allocated uninitialised; fill them with
    ``init_params`` (random, from a seed; see ``models.base.PortedLM``) or
    :func:`repro_torch.bridge.hybrid_from_arrays` (the reference's
    arrays). It has no ``decode_block``, so no speculative lanes, as in
    the reference.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family != "hybrid":
            raise NotImplementedError(
                f"HybridModel carries the hybrid family, not {cfg.family!r}")
        if not (cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0):
            raise ValueError(f"{cfg.n_layers} layers do not split into "
                             f"groups of attn_every={cfg.attn_every}")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.embed = nn.ParameterDict({"table": nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw), requires_grad=False)})
        self.mamba_blocks = nn.ModuleList([
            nn.ModuleList([MambaLayer(cfg, **kw)
                           for _ in range(cfg.attn_every)])
            for _ in range(self.n_groups)])
        # ONE shared attention block, reused after every group
        self.shared_attn = AttnBlock(cfg, **kw)
        self.ln_f = norm_params(cfg.d_model, **kw)
        self.head = nn.ParameterDict({"w": nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, **kw), requires_grad=False)})

    def ffn_blocks(self):
        return [self.shared_attn]

    # -- prefill --------------------------------------------------------------

    def _group(self, x: torch.Tensor, group: nn.ModuleList,
               positions: torch.Tensor) -> torch.Tensor:
        """One group's Mamba2 layers, then the shared attention block."""
        cfg = self.cfg
        for layer in group:
            x = x + mamba2(layer.mamba, rmsnorm(layer.ln, x),
                           head_dim=cfg.ssm_head_dim,
                           d_state=cfg.ssm_state, chunk=cfg.ssd_chunk)
            x = shard_act(x, "batch", "seq", "act_embed")
        x, _ = self.shared_attn(x, positions, cfg)
        return x

    def backbone(self, tokens: torch.Tensor) -> torch.Tensor:
        """The normed hiddens [B, S, d] of ``tokens`` [B, S]; each group is
        checkpointed under ``cfg.remat`` while autograd records."""
        B, S = tokens.shape
        x = embed(self.embed, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for group in self.mamba_blocks:
            x = remat(self._group, x, group, positions,
                      enabled=self.cfg.remat)
        return rmsnorm(self.ln_f, x)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training objective (fp32 scalar): the mean next-token
        cross-entropy of ``batch["tokens"]`` against ``batch["labels"]``
        (autograd records through it)."""
        x = self.backbone(batch["tokens"])
        return lm_loss_chunked(self.head["w"], x, batch["labels"])

    @serving
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill entry point: fp32 logits [B, S, V] for ``batch["tokens"]``
        [B, S]."""
        x = self.backbone(batch["tokens"])
        return shard_act(matmul_f32(x, self.head["w"]), "batch", "seq",
                         "vocab")

    # -- decode ---------------------------------------------------------------

    def decode_state_specs(self, batch: int, max_len: int
                           ) -> Dict[str, ParamSpec]:
        """The reference's ``decode_state_specs``, in its layout: ``ssm``
        [G, E, B, H, P, N] and ``conv`` [G, E, B, 3, d_inner] in fp32 (the
        port's leaves flatten [G, E] to one dim; ``models.base.port_layout``
        maps one onto the other), the bf16 KV caches [G, B, max_len, KV,
        hd]."""
        cfg = self.cfg
        G, E = self.n_groups, cfg.attn_every
        H, P, N = self.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
            cfg.ssm_state
        kv = ParamSpec((G, batch, max_len, cfg.n_kv, cfg.head_dim),
                       ("layers", "batch", "seq", "cache_heads", "cache_hd"),
                       torch.bfloat16, "zeros")
        return {
            "ssm": ParamSpec((G, E, batch, H, P, N),
                             ("layers", "layers", "batch", "mlp", None, None),
                             torch.float32, "zeros"),
            "conv": ParamSpec((G, E, batch, D_CONV - 1, self.d_inner),
                              ("layers", "layers", "batch", None, "act_mlp"),
                              torch.float32, "zeros"),
            "cache_k": kv,
            "cache_v": kv,
        }

    def decode_state(self, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     only: Optional[str] = None,
                     draft_layers: int = 0) -> Dict[str, torch.Tensor]:
        """A zeroed decode state on the model's device (the reference's
        ``decode_state_specs``, allocated): ``ssm`` [n_layers, B, H, P, N]
        and ``conv`` [n_layers, B, 3, d_inner] in fp32, and a bf16 KV cache
        per shared-block call site, ``cache_k``/``cache_v`` [G, B, max_len,
        KV, hd].

        With ``paged=(page_count, page_size)`` the KV leaves are the shared
        page pool [G, page_count, page_size, KV, hd]; ``only`` picks one
        half of a paged state: ``"pool"`` the KV leaves, ``"dense"`` the
        per-slot SSM and conv leaves. The model has no speculative draft,
        so ``draft_layers`` must be 0."""
        if draft_layers:
            raise ValueError("the hybrid family has no block-verify decode "
                             "path (decode_block), so no draft state")
        cfg = self.cfg
        dev = self.device
        state: Dict[str, torch.Tensor] = {}
        if not (paged is not None and only == "pool"):
            spec = mamba2_state_spec(batch, cfg.n_layers, self.d_inner,
                                     cfg.ssm_head_dim, cfg.ssm_state)
            state.update({name: torch.zeros(shape, dtype=torch.float32,
                                            device=dev)
                          for name, shape in spec.items()})
        if not (paged is not None and only == "dense"):
            per_slot = (batch, max_len) if paged is None else tuple(paged)
            state.update({name: torch.zeros(
                (self.n_groups, *per_slot, cfg.n_kv, cfg.head_dim),
                dtype=torch.bfloat16, device=dev)
                for name in PAGED_STATE_KEYS})
        return state

    @serving
    def decode_step(self, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, *,
                    window_start: Optional[torch.Tensor] = None,
                    pages: Optional[PageView] = None):
        """One token for every sequence: tokens [B] int, ``pos`` the
        position of the new token. Writes every leaf of ``state`` in place
        (the reference returned a new state) and returns ``(logits [B, V]
        fp32, state)``. ``window_start`` and ``pages`` reach the shared
        block's attention as in ``DecoderLM.decode_step``; the Mamba2
        layers are recurrent and ignore both (a fresh slot's SSM and conv
        lanes are zeroed by the caller's wipe instead)."""
        cfg = self.cfg
        x = embed(self.embed, tokens[:, None])
        ssm, conv = state["ssm"], state["conv"]
        for g, group in enumerate(self.mamba_blocks):
            for e, layer in enumerate(group):
                i = g * cfg.attn_every + e
                o, s, c = mamba2_decode(layer.mamba, rmsnorm(layer.ln, x),
                                        ssm[i], conv[i],
                                        head_dim=cfg.ssm_head_dim)
                ssm[i].copy_(s)
                conv[i].copy_(c)
                x = x + o
            x, _, _ = self.shared_attn.decode(
                x, state["cache_k"][g], state["cache_v"][g], pos, cfg,
                window_start=window_start, pages=pages)
        return self.head_logits(rmsnorm(self.ln_f, x)), state
