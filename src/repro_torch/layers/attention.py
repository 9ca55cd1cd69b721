"""Attention: GQA self-attention and KV-cache decode (the dense parts).

Prefill uses a query-chunked attention so the score matrix never lives at
[B, H, S, S], or, behind ``USE_FLASH_KERNEL``, the flash-attention kernel
(the hand-written CUDA kernel for tensors on the card, its plain version
for tensors on the CPU). Decode attends one new token over the cache.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.layers.linear import linear
from repro_torch.layers.rope import apply_rope, rope_freqs

NEG_INF = -1e30

# Route the inner attention of a self-attention prefill through the flash
# kernel. On by default: the value the reference names for its TPU
# deployment (its CPU dry-run keeps it off).
USE_FLASH_KERNEL = True

Params = Mapping[str, Mapping[str, torch.Tensor]]


def _attend_block(
    q: torch.Tensor,          # [B, Cq, H, hd]
    k: torch.Tensor,          # [B, Sk, H, hd]  (kv heads already repeated)
    v: torch.Tensor,          # [B, Sk, H, hd]
    q_pos0: Union[int, torch.Tensor],   # global position of q[:, 0]
    kv_valid: Optional[torch.Tensor],   # [B, Sk] bool or None
    causal: bool,
    scale: float,
) -> torch.Tensor:
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    Sq, Sk = q.shape[1], k.shape[1]
    if causal:
        qi = q_pos0 + torch.arange(Sq, device=q.device)
        si = torch.arange(Sk, device=q.device)
        mask = si[None, :] <= qi[:, None]                  # [Sq, Sk]
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    if kv_valid is not None:
        scores = scores.masked_fill(~kv_valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # the probabilities are rounded to v's dtype before the PV product, as
    # in the reference; the product itself accumulates in fp32
    out = torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def mha(
    q: torch.Tensor,          # [B, Sq, H, hd]
    k: torch.Tensor,          # [B, Sk, KV, hd]
    v: torch.Tensor,          # [B, Sk, KV, hd]
    *,
    causal: bool = True,
    q_start: Union[int, torch.Tensor] = 0,
    kv_valid: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Grouped-query attention with query chunking.

    GQA is computed in head-repeat form, as in the reference: the kv heads
    are repeated up to the full H. A self-attention prefill (no validity
    mask, Sq == Sk, hd % 8 == 0) goes through the flash kernel when
    ``USE_FLASH_KERNEL`` is set.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    G = H // KV
    scale = hd ** -0.5
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)          # [B, Sk, H, hd]
        v = torch.repeat_interleave(v, G, dim=2)

    if USE_FLASH_KERNEL and kv_valid is None and Sq == k.shape[1] \
            and hd % 8 == 0:
        qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
        kf = k.transpose(1, 2).reshape(B * H, -1, hd)
        vf = v.transpose(1, 2).reshape(B * H, -1, hd)
        o = flash_attention(qf, kf, vf, causal=causal,
                            q_start=0 if torch.is_tensor(q_start)
                            else int(q_start))
        return o.reshape(B, H, Sq, hd).transpose(1, 2)

    if Sq <= q_chunk or Sq % q_chunk:
        return _attend_block(q, k, v, q_start, kv_valid, causal, scale)
    outs = [
        _attend_block(q[:, i:i + q_chunk], k, v, q_start + i, kv_valid,
                      causal, scale)
        for i in range(0, Sq, q_chunk)
    ]
    return torch.cat(outs, dim=1)


def self_attention(
    params: Params,
    x: torch.Tensor,              # [B, S, d]
    positions: torch.Tensor,      # [B, S]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    causal: bool = True,
    q_chunk: int = 1024,
) -> torch.Tensor:
    B, S, _ = x.shape
    q = linear(params["wq"], x).reshape(B, S, n_heads, head_dim)
    k = linear(params["wk"], x).reshape(B, S, n_kv, head_dim)
    v = linear(params["wv"], x).reshape(B, S, n_kv, head_dim)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    o = mha(q, k, v, causal=causal, q_chunk=q_chunk)
    return linear(params["wo"], o.reshape(B, S, n_heads * head_dim))


def decode_self_attention(
    params: Params,
    x: torch.Tensor,              # [B, 1, d] current token hidden
    cache_k: torch.Tensor,        # [B, S, KV, hd] this layer's cache
    cache_v: torch.Tensor,
    pos: int,                     # index of the new token
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 10000.0,
    window_start: Optional[torch.Tensor] = None,   # [B] int or None
):
    """One decode step: project, rotate, append to the cache, attend.

    The new K/V row is written into ``cache_k``/``cache_v`` IN PLACE (the
    reference returned updated copies); the returned caches are the same
    tensors. ``window_start`` restricts sequence ``b`` to cache positions
    ``[window_start[b], pos]``; ``None`` keeps the full prefix.

    Returns (out [B, 1, d], cache_k, cache_v).
    """
    B = x.shape[0]
    S = cache_k.shape[1]
    if not 0 <= pos < S:
        raise ValueError(f"decode position {pos} outside the cache [0, {S})")
    q = linear(params["wq"], x).reshape(B, 1, n_heads, head_dim)
    k = linear(params["wk"], x).reshape(B, 1, n_kv, head_dim)
    v = linear(params["wv"], x).reshape(B, 1, n_kv, head_dim)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    idx = torch.arange(S, device=x.device)
    kv_valid = (idx <= pos)[None, :].expand(B, S)
    if window_start is not None:
        kv_valid = kv_valid & (idx[None, :] >= window_start[:, None])
    o = mha(q, cache_k, cache_v, causal=False, kv_valid=kv_valid)
    out = linear(params["wo"], o.reshape(B, 1, n_heads * head_dim))
    return out, cache_k, cache_v
