"""Seamless-M4T-v2-class encoder-decoder (audio frontend stubbed).

Encoder: bidirectional self-attention + GELU MLP over precomputed frame
embeddings. Decoder: causal self-attention + cross-attention on the
encoder's output + GELU MLP over text tokens. LayerNorm (not RMSNorm), as
in the original architecture. A prefill's decoder runs ``max(S //
dec_ratio, 128)`` tokens over S frames (``models.base.prefill_inputs``).

The reference scanned stacked ``enc_blocks`` and ``dec_blocks``; here each
is an ``nn.ModuleList`` and the scans are loops. Decode keeps a KV cache
per decoder layer and the cross-attention keys and values of the memory
(``cross_k``/``cross_v``), which nothing in serving fills: as in the
reference, a served stream attends over zero memory.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.emit import DeviceLike, resolve_device
from repro_torch.dist.sharding import ParamSpec, serving, shard_act
from repro_torch.dist.staging import layers, materialized
from repro_torch.layers.attention import (
    cross_attention,
    decode_cross_attention,
    decode_self_attention,
    paged_decode_self_attention,
    self_attention,
)
from repro_torch.layers.embedding import embed
from repro_torch.layers.linear import matmul_f32
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norm import layernorm
from repro_torch.layers.remat import remat
from repro_torch.models.base import (
    CROSS_STATE_KEYS,
    PAGED_STATE_KEYS,
    ArchConfig,
    InputSpecs,
    PageView,
    PortedLM,
    ShapeSpec,
    decode_input_specs,
    lm_loss_chunked,
    token_input_specs,
)
from repro_torch.models.blocks import (
    attention_params,
    layernorm_params,
    mlp_params,
)


class EncDecBlock(nn.Module):
    """One encoder layer (``ln1``, ``attn``, ``ln2``, ``ffn`` with biased
    ``up`` and ``down``) or, with ``cross``, one decoder layer, which adds
    ``ln_x`` and ``xattn``; the names follow the reference's tree."""

    def __init__(self, cfg: ArchConfig, *, cross: bool, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = layernorm_params(cfg.d_model, **kw)
        self.attn = attention_params(cfg, **kw)
        self.ln2 = layernorm_params(cfg.d_model, **kw)
        self.ffn = mlp_params(cfg.d_model, cfg.d_ff, **kw)
        if cross:
            self.ln_x = layernorm_params(cfg.d_model, **kw)
            self.xattn = attention_params(cfg, **kw)

    def mlp_part(self, x: torch.Tensor) -> torch.Tensor:
        return x + mlp(self.ffn, layernorm(self.ln2, x), act="gelu")

    def layer_out(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP part, then a prefill layer's output constraint."""
        return shard_act(self.mlp_part(x), "batch", "seq", "act_embed")


class EncDecLM(PortedLM, nn.Module):
    """The encoder-decoder with its parameters, on one device.

    Parameters are allocated uninitialised; fill them with
    ``init_params`` (random, from a seed; see ``models.base.PortedLM``) or
    :func:`repro_torch.bridge.encdec_from_arrays` (the reference's
    arrays). Its GELU MLP has no quantized route and its decode head
    ignores ``cfg.quantized``, as in the reference, so a quantized plan
    runs it all float. It has no ``decode_block``, so no speculative
    lanes.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.family != "encdec":
            raise NotImplementedError(
                f"EncDecLM carries the encdec family, not {cfg.family!r}")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.embed = nn.ParameterDict({"table": nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw), requires_grad=False)})
        self.enc_blocks = nn.ModuleList(
            [EncDecBlock(cfg, cross=False, **kw) for _ in range(self.n_enc)])
        self.dec_blocks = nn.ModuleList(
            [EncDecBlock(cfg, cross=True, **kw)
             for _ in range(cfg.n_layers)])
        self.ln_enc = layernorm_params(cfg.d_model, **kw)
        self.ln_f = layernorm_params(cfg.d_model, **kw)
        self.head = nn.ParameterDict({"w": nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, **kw), requires_grad=False)})

    def _heads(self) -> Dict[str, int]:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                    head_dim=cfg.head_dim)

    # -- prefill --------------------------------------------------------------

    def _enc_layer(self, x: torch.Tensor, blk: EncDecBlock,
                   positions: torch.Tensor) -> torch.Tensor:
        with materialized(blk):
            x = x + self_attention(blk.attn, layernorm(blk.ln1, x),
                                   positions, causal=False,
                                   q_chunk=self.cfg.q_chunk, **self._heads())
            return blk.layer_out(x)

    def _dec_layer(self, x: torch.Tensor, blk: EncDecBlock,
                   positions: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
        q_chunk = self.cfg.q_chunk
        with materialized(blk):
            x = x + self_attention(blk.attn, layernorm(blk.ln1, x),
                                   positions, causal=True, q_chunk=q_chunk,
                                   **self._heads())
            x = x + cross_attention(blk.xattn, layernorm(blk.ln_x, x),
                                    memory, q_chunk=q_chunk, **self._heads())
            return blk.layer_out(x)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The memory [B, S, d] of frame embeddings [B, S, d]; each layer
        is checkpointed under ``cfg.remat`` while autograd records."""
        B, S, _ = frames.shape
        x = shard_act(frames, "batch", "seq", "act_embed")
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for blk in self.enc_blocks:
            x = remat(self._enc_layer, x, blk, positions,
                      enabled=self.cfg.remat)
        return layernorm(self.ln_enc, x)

    def decode_stack(self, tokens: torch.Tensor,
                     memory: torch.Tensor) -> torch.Tensor:
        """The normed decoder hiddens [B, S, d] of ``tokens`` [B, S] over
        ``memory``; each layer is checkpointed under ``cfg.remat`` while
        autograd records."""
        B, S = tokens.shape
        x = embed(self.embed, tokens)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for blk in self.dec_blocks:
            x = remat(self._dec_layer, x, blk, positions, memory,
                      enabled=self.cfg.remat)
        return layernorm(self.ln_f, x)

    @serving
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill entry point: fp32 logits [B, S_dec, V] for
        ``batch["tokens"]`` [B, S_dec] over ``batch["frames"]`` [B, S,
        d]."""
        memory = self.encode(batch["frames"])
        x = self.decode_stack(batch["tokens"], memory)
        return shard_act(matmul_f32(x, self.head["w"]), "batch", "seq",
                         "vocab")

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training objective (fp32 scalar): the mean next-token
        cross-entropy of the decoder's ``batch["tokens"]`` [B, S_dec]
        against ``batch["labels"]``, over ``batch["frames"]`` [B, S, d]
        (autograd records through it)."""
        memory = self.encode(batch["frames"])
        x = self.decode_stack(batch["tokens"], memory)
        return lm_loss_chunked(self.head["w"], x, batch["labels"])

    # -- decode ---------------------------------------------------------------

    def decode_state_specs(self, batch: int, max_len: int
                           ) -> Dict[str, ParamSpec]:
        """The reference's ``decode_state_specs``: the bf16 KV caches [L,
        B, max_len, KV, hd] and cross caches [L, B, max(max_len //
        dec_ratio, 128), KV, hd]."""
        cfg = self.cfg
        mem_len = max(max_len // cfg.dec_ratio, 128)
        axes = ("layers", "batch", "seq", "cache_heads", "cache_hd")
        lens = dict.fromkeys(PAGED_STATE_KEYS, max_len)
        lens.update(dict.fromkeys(CROSS_STATE_KEYS, mem_len))
        return {name: ParamSpec((cfg.n_layers, batch, n, cfg.n_kv,
                                 cfg.head_dim), axes, torch.bfloat16,
                                "zeros")
                for name, n in lens.items()}

    def decode_state(self, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     only: Optional[str] = None,
                     draft_layers: int = 0) -> Dict[str, torch.Tensor]:
        """A zeroed bf16 decode state on the model's device (the
        reference's ``decode_state_specs``, allocated): ``cache_k`` and
        ``cache_v`` [L, B, max_len, KV, hd], and ``cross_k``/``cross_v``
        [L, B, max(max_len // dec_ratio, 128), KV, hd].

        With ``paged=(page_count, page_size)`` the self-attention caches
        are the shared page pool [L, page_count, page_size, KV, hd] and
        the cross caches stay per slot; ``only`` picks one half of a paged
        state: ``"pool"`` the pool leaves, ``"dense"`` the cross caches.
        The model has no speculative draft, so ``draft_layers`` must be
        0."""
        if draft_layers:
            raise ValueError("the encdec family has no block-verify decode "
                             "path (decode_block), so no draft state")
        cfg = self.cfg
        mem_len = max(max_len // cfg.dec_ratio, 128)
        shapes = {}
        if not (paged is not None and only == "pool"):
            shapes.update({name: (batch, mem_len)
                           for name in CROSS_STATE_KEYS})
        if not (paged is not None and only == "dense"):
            per_slot = (batch, max_len) if paged is None else tuple(paged)
            shapes.update({name: per_slot for name in PAGED_STATE_KEYS})
        return {name: torch.zeros((cfg.n_layers, *s, cfg.n_kv, cfg.head_dim),
                                  dtype=torch.bfloat16, device=self.device)
                for name, s in shapes.items()}

    def input_specs(self, shape: ShapeSpec) -> InputSpecs:
        """The reference's ``input_specs``: frame embeddings [B, S, d] and
        a decoder run of ``max(S // dec_ratio, 128)`` tokens and labels for
        a train or prefill shape; one token and its position to decode."""
        B = shape.global_batch
        if shape.kind in ("train", "prefill"):
            dec_len = max(shape.seq_len // self.cfg.dec_ratio, 128)
            return {"frames": ((B, shape.seq_len, self.cfg.d_model),
                               torch.bfloat16),
                    **token_input_specs(B, dec_len)}
        return decode_input_specs(B)

    @serving
    def decode_step(self, state: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, *,
                    window_start: Optional[torch.Tensor] = None,
                    pages: Optional[PageView] = None):
        """One token for every sequence: tokens [B] int, ``pos`` the
        position of the new token. Writes the KV caches of ``state`` in
        place and returns ``(logits [B, V] fp32, state)``; the cross
        caches are read only. ``window_start`` and ``pages`` reach the
        self-attention as in ``DecoderLM.decode_step``. The head is the
        float product whatever ``cfg.quantized`` says, as in the
        reference."""
        x = embed(self.embed, tokens[:, None])
        cfg = self.cfg
        for i, blk in enumerate(self.dec_blocks):
            with layers(i, state["cache_k"], state["cache_v"],
                        batch=pages is None) as (ck, cv), \
                    layers(i, state["cross_k"], state["cross_v"]) as (
                        xk, xv), materialized(blk):
                h = layernorm(blk.ln1, x)
                if pages is not None:
                    h, _, _ = paged_decode_self_attention(
                        blk.attn, h, ck, cv, pages, **self._heads())
                else:
                    h, _, _ = decode_self_attention(
                        blk.attn, h, ck, cv, pos, window_start=window_start,
                        **self._heads())
                x = x + h
                x = x + decode_cross_attention(
                    blk.xattn, layernorm(blk.ln_x, x), xk, xv,
                    n_heads=cfg.n_heads, head_dim=cfg.head_dim)
                x = blk.mlp_part(x)
        x = layernorm(self.ln_f, x)
        return matmul_f32(x, self.head["w"])[:, 0], state
