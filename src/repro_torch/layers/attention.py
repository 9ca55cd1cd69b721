"""Attention: GQA self-attention, cross-attention and KV-cache decode,
dense and paged.

Prefill uses a query-chunked attention so the score matrix never lives at
[B, H, S, S], or, behind ``USE_FLASH_KERNEL``, the flash-attention kernel
(the hand-written CUDA kernel for tensors on the card, its plain version
for tensors on the CPU). Decode attends one new token over the cache: a
dense [B, S, KV, hd] slab per layer, or the shared page pool through each
slot's page table (plain torch indexing, as in the reference). The block
decode variants score m consecutive tokens per slot in one pass, at each
slot's local positions (the speculative draft and verify).
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.dist.sharding import (
    is_dtensor,
    local_einsum,
    reshape,
    shard_act,
    whole,
)
from repro_torch.kernels.flash_attention.ops import accepts as flash_accepts
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.layers.linear import bmm_f32, linear
from repro_torch.layers.remat import remat
from repro_torch.layers.rope import apply_rope, rope_freqs

NEG_INF = -1e30

# Route the inner attention of a self-attention prefill through the flash
# kernel. On by default: the value the reference names for its TPU
# deployment (its CPU dry-run keeps it off).
USE_FLASH_KERNEL = True

Params = Mapping[str, Mapping[str, torch.Tensor]]


def _products(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              recorded: bool):
    """``(scores, pv)``: the two products of the attention, each summed in
    fp32 with an fp32 output. The serving paths upcast q, k, v and the
    probabilities; a recorded (training) call runs them as batched
    :func:`~repro_torch.layers.linear.bmm_f32` products of the operands
    as they are, which on the card are bf16 tensor-core GEMMs with a
    backward (the reference's ``preferred_element_type`` products: a bf16
    product is exact in fp32, so the two differ only in summation order)."""
    if not recorded:
        einsum = (local_einsum if any(map(is_dtensor, (q, k, v)))
                  else torch.einsum)
        return (einsum("bqhd,bshd->bhqs", q.float(), k.float()),
                lambda p: einsum("bhqs,bshd->bqhd", p.float(), v.float()))
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scores = bmm_f32(reshape(q.transpose(1, 2), B * H, Sq, hd),
                     reshape(k.permute(0, 2, 3, 1), B * H, hd, Sk))

    def pv(p: torch.Tensor) -> torch.Tensor:
        out = bmm_f32(reshape(p, B * H, Sq, Sk),
                      reshape(v.transpose(1, 2), B * H, Sk, hd))
        return reshape(out, B, H, Sq, hd).transpose(1, 2)

    return reshape(scores, B, H, Sq, Sk), pv


def _attend_block(
    q: torch.Tensor,          # [B, Cq, H, hd]
    k: torch.Tensor,          # [B, Sk, H, hd]  (kv heads already repeated)
    v: torch.Tensor,          # [B, Sk, H, hd]
    q_pos0: Union[int, torch.Tensor],   # global position of q[:, 0]
    kv_valid: Optional[torch.Tensor],   # [B, Sk] / [B, Sq, Sk] bool or None
    causal: bool,
    scale: float,
    recorded: bool = False,
) -> torch.Tensor:
    scores, pv = _products(q, k, v, recorded)
    scores = scores * scale
    Sq, Sk = q.shape[1], k.shape[1]
    if causal:
        qi = q_pos0 + torch.arange(Sq, device=q.device)
        si = torch.arange(Sk, device=q.device)
        mask = si[None, :] <= qi[:, None]                  # [Sq, Sk]
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    if kv_valid is not None:
        # [B, Sk] masks every query alike; [B, Sq, Sk] is the per-query
        # form of block decode (query j may see one row more than j - 1)
        mask = (kv_valid[:, None, None, :] if kv_valid.dim() == 2
                else kv_valid[:, None])
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # the probabilities are rounded to v's dtype before the PV product, as
    # in the reference; the product itself accumulates in fp32
    return pv(p.to(v.dtype)).to(v.dtype)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor,
                vals: torch.Tensor) -> None:
    """``cache[b, rows[b, j]] = vals[b, j]`` in place: ``cache`` [B, S, KV,
    hd], ``rows`` [B, m] positions, ``vals`` [B, m, KV, hd]. A DTensor
    cache (sharded by batch, or by sequence under megatron_sp, where an
    indexed write would land on a gathered copy) is written as a select
    per block row, ``cache <- where(position == row, value, cache)``,
    which DTensor runs on each rank's own slice."""
    if not is_dtensor(cache):
        lanes = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[lanes, rows] = vals
        return
    pos = torch.arange(cache.shape[1], device=rows.device)
    for j in range(rows.shape[1]):
        hit = (pos[None, :] == rows[:, j:j + 1])[:, :, None, None]
        cache.copy_(torch.where(hit, vals[:, j:j + 1], cache))


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
    mask, Sq == Sk) goes through the flash kernel when
    ``USE_FLASH_KERNEL`` is set, ``hd % 8 == 0`` (the reference's rule)
    and the reference wrapper would accept the blocks; every other call
    runs the plain path, as in the reference, whose switch is off. A head
    dim the kernel is not built for raises on the card.

    A call whose inputs require grad (training) never reaches the kernel,
    which has no backward: it runs the plain path, as the reference's
    training does, each query chunk checkpointed (recomputed in the
    backward pass, as the reference's ``jax.checkpoint`` does).
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
    # seq first: a seq-sharded KV (megatron_sp) takes precedence over head
    # sharding; fit_pspec drops the duplicate (the reference's constraint)
    k = shard_act(k, "batch", "seq", "act_heads", None)
    v = shard_act(v, "batch", "seq", "act_heads", None)
    if Sq == k.shape[1]:
        # a prefill gathers its keys over the sequence, as Megatron's
        # sequence parallelism does before attention (a port step: DTensor
        # would split the softmax-weighted sum over the sequence shards);
        # a decode step's cache keeps the flash-decoding layout
        k, v = whole(k, 1), whole(v, 1)

    records = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if USE_FLASH_KERNEL and not records and kv_valid is None \
            and Sq == k.shape[1] and flash_accepts(Sq, Sq, hd, causal):
        qf = reshape(q.transpose(1, 2), B * H, Sq, hd)
        kf = reshape(k.transpose(1, 2), B * H, -1, hd)
        vf = reshape(v.transpose(1, 2), B * H, -1, hd)
        o = flash_attention(qf, kf, vf, causal=causal,
                            q_start=0 if torch.is_tensor(q_start)
                            else int(q_start))
        return reshape(o, B, H, Sq, hd).transpose(1, 2)

    if Sq <= q_chunk or Sq % q_chunk:
        return _attend_block(q, k, v, q_start, kv_valid, causal, scale,
                             records)
    outs = [
        remat(_attend_block, q[:, i:i + q_chunk], k, v, q_start + i,
              kv_valid, causal, scale, records, enabled=records)
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
    q = reshape(linear(params["wq"], x), B, S, n_heads, head_dim)
    k = reshape(linear(params["wk"], x), B, S, n_kv, head_dim)
    v = reshape(linear(params["wv"], x), B, S, n_kv, head_dim)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    q = shard_act(q, "batch", "seq", "act_heads", None)
    o = mha(q, k, v, causal=causal, q_chunk=q_chunk)
    o = shard_act(o, "batch", "seq", "act_heads", None)
    return linear(params["wo"], reshape(o, B, S, n_heads * head_dim))


def cross_attention(
    params: Params,
    x: torch.Tensor,              # [B, Sq, d]
    memory: torch.Tensor,         # [B, Sm, d_mem] (encoder / vision states)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    memory_valid: Optional[torch.Tensor] = None,   # [B, Sm] bool or None
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Queries from ``x``, keys and values from ``memory``, no RoPE and no
    causal mask; ``memory_valid`` hides memory rows. Through :func:`mha`,
    so flash runs only where the reference would run it (Sq == Sm and no
    mask)."""
    B, Sq, _ = x.shape
    Sm = memory.shape[1]
    q = reshape(linear(params["wq"], x), B, Sq, n_heads, head_dim)
    k = reshape(linear(params["wk"], memory), B, Sm, n_kv, head_dim)
    v = reshape(linear(params["wv"], memory), B, Sm, n_kv, head_dim)
    q = shard_act(q, "batch", "seq", "act_heads", None)
    o = mha(q, k, v, causal=False, kv_valid=memory_valid, q_chunk=q_chunk)
    return linear(params["wo"], reshape(o, B, Sq, n_heads * head_dim))


def decode_cross_attention(
    params: Params,
    x: torch.Tensor,              # [B, 1, d] current token hidden
    cross_k: torch.Tensor,        # [B, Sm, KV, hd] the memory's keys
    cross_v: torch.Tensor,
    *,
    n_heads: int,
    head_dim: int,
) -> torch.Tensor:
    """One decode token's cross-attention over the memory's precomputed
    keys and values (the decode state's ``cross_k``/``cross_v``), through
    the plain path of :func:`mha`. Returns [B, 1, d]."""
    B = x.shape[0]
    q = reshape(linear(params["wq"], x), B, 1, n_heads, head_dim)
    o = mha(q, cross_k, cross_v, causal=False)
    return linear(params["wo"], reshape(o, B, 1, n_heads * head_dim))


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
    q = reshape(linear(params["wq"], x), B, 1, n_heads, head_dim)
    k = reshape(linear(params["wk"], x), B, 1, n_kv, head_dim)
    v = reshape(linear(params["wv"], x), B, 1, n_kv, head_dim)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    if is_dtensor(cache_k):
        rows = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        _write_rows(cache_k, rows, k)
        _write_rows(cache_v, rows, v)
    else:
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
    idx = torch.arange(S, device=x.device)
    kv_valid = (idx <= pos)[None, :].expand(B, S)
    if window_start is not None:
        kv_valid = kv_valid & (idx[None, :] >= window_start[:, None])
    o = mha(q, cache_k, cache_v, causal=False, kv_valid=kv_valid)
    out = linear(params["wo"], reshape(o, B, 1, n_heads * head_dim))
    return out, cache_k, cache_v


def paged_decode_self_attention(
    params: Params,
    x: torch.Tensor,              # [B, 1, d] current token hidden
    cache_k: torch.Tensor,        # [P, ps, KV, hd] this layer's page pool
    cache_v: torch.Tensor,
    pages,                        # models.base.PageView
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 10000.0,
):
    """One decode step against the paged KV layout.

    Each slot ``b`` lives in its own coordinates: ``local_pos[b]`` (clipped
    to ``[0, S - 1]``) is its position in its own sequence, page ``j`` of
    its table holds local positions ``[j*ps, (j+1)*ps)``, and RoPE rotates
    by the local position. The new K/V row is scattered IN PLACE to
    ``(table[b, local//ps], local % ps)``. The caller guarantees that no
    two lanes write the same row (empty and self-masked lanes carry their
    own scratch pages), since duplicate indices in one ``index_put_`` have
    no defined order on CUDA. The read gathers the slot's whole table into
    ``[B, S, KV, hd]``, masks to ``j <= local[b]`` and goes through the
    same :func:`mha` as the dense decode.

    Returns (out [B, 1, d], cache_k, cache_v), the caches being the same
    tensors.
    """
    B = x.shape[0]
    ps = pages.page_size
    table = pages.table.long()
    S = table.shape[1] * ps
    q = reshape(linear(params["wq"], x), B, 1, n_heads, head_dim)
    k = reshape(linear(params["wk"], x), B, 1, n_kv, head_dim)
    v = reshape(linear(params["wv"], x), B, 1, n_kv, head_dim)
    local = pages.local_pos.long().clamp(0, S - 1)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, local[:, None], inv_freq)
    k = apply_rope(k, local[:, None], inv_freq)
    page_ids = table.gather(1, (local // ps)[:, None])[:, 0]
    offs = local % ps
    cache_k[page_ids, offs] = k[:, 0]
    cache_v[page_ids, offs] = v[:, 0]
    k_all = reshape(cache_k[table], B, S, n_kv, head_dim)
    v_all = reshape(cache_v[table], B, S, n_kv, head_dim)
    kv_valid = torch.arange(S, device=x.device)[None, :] <= local[:, None]
    o = mha(q, k_all, v_all, causal=False, kv_valid=kv_valid)
    out = linear(params["wo"], reshape(o, B, 1, n_heads * head_dim))
    return out, cache_k, cache_v


def _block_write_rows(posb: torch.Tensor, S: int, k: torch.Tensor,
                      v: torch.Tensor, last_k: torch.Tensor,
                      last_v: torch.Tensor):
    """Positions and rows to write for a block, with the out-of-range ones
    dropped.

    ``posb`` [B, m] are each slot's local positions (consecutive per slot),
    ``k``/``v`` [B, m, KV, hd] the rows, ``last_k``/``last_v`` [B, KV, hd]
    the current contents of each slot's last position ``S - 1``. The
    reference's scatter drops a write outside ``[0, S)``; an ``index_put_``
    cannot skip an index without a host sync, so a dropped write becomes a
    write of position ``S - 1`` carrying the value that row holds once the
    block is written: the block's own row for ``S - 1`` if the block
    covers it, else the row's current contents. Every write to one row
    then carries one value, so the order of duplicates cannot matter and
    no row changes that the reference leaves alone.
    """
    m = posb.shape[1]
    in_range = (posb >= 0) & (posb < S)
    j_last = (S - 1) - posb[:, 0]                       # [B]
    covers = (j_last >= 0) & (j_last < m)
    pick = j_last.clamp(0, m - 1)[:, None, None, None].expand(
        -1, 1, *k.shape[2:])
    fill_k = torch.where(covers[:, None, None], k.gather(1, pick)[:, 0],
                         last_k)
    fill_v = torch.where(covers[:, None, None], v.gather(1, pick)[:, 0],
                         last_v)
    keep = in_range[:, :, None, None]
    return (torch.where(in_range, posb, S - 1),
            torch.where(keep, k, fill_k[:, None]),
            torch.where(keep, v, fill_v[:, None]))


def block_decode_self_attention(
    params: Params,
    x: torch.Tensor,              # [B, m, d] block of token hiddens
    cache_k: torch.Tensor,        # [B, S, KV, hd] this layer's cache
    cache_v: torch.Tensor,
    local: torch.Tensor,          # [B] int: local position of x[:, 0]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 10000.0,
):
    """Decode a block of ``m`` consecutive tokens per slot in one pass.

    Slot ``b``'s token ``j`` lives at row ``local[b] + j`` of its own lane:
    RoPE rotates by that (unclamped) position, the row is written IN PLACE,
    and query ``j`` attends over rows ``<= local[b] + j``. Rows a rejected
    speculative suffix leaves behind sit at or above the rewound cursor,
    where the next block's writes replace them before any mask admits
    them, so a rollback needs no cache surgery. Writes outside ``[0, S)``
    are dropped, as the reference's scatter drops them. ``m == 1`` is the
    draft's step, ``m == k`` the target's verify pass.

    Returns (out [B, m, d], cache_k, cache_v), the caches being the same
    tensors.
    """
    B, m, _ = x.shape
    S = cache_k.shape[1]
    q = reshape(linear(params["wq"], x), B, m, n_heads, head_dim)
    k = reshape(linear(params["wk"], x), B, m, n_kv, head_dim)
    v = reshape(linear(params["wv"], x), B, m, n_kv, head_dim)
    posb = local.long()[:, None] + torch.arange(m, device=x.device)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    rows, k_w, v_w = _block_write_rows(posb, S, k, v, cache_k[:, S - 1],
                                       cache_v[:, S - 1])
    _write_rows(cache_k, rows, k_w)
    _write_rows(cache_v, rows, v_w)
    # query j of slot b sees exactly rows [0, local[b] + j]
    kv_valid = (torch.arange(S, device=x.device)[None, None, :]
                <= posb[:, :, None])
    o = mha(q, cache_k, cache_v, causal=False, kv_valid=kv_valid)
    out = linear(params["wo"], reshape(o, B, m, n_heads * head_dim))
    return out, cache_k, cache_v


def paged_block_decode_self_attention(
    params: Params,
    x: torch.Tensor,              # [B, m, d] block of token hiddens
    cache_k: torch.Tensor,        # [P, ps, KV, hd] this layer's page pool
    cache_v: torch.Tensor,
    pages,                        # models.base.PageView; local_pos of x[:, 0]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 10000.0,
):
    """Block decode of ``m`` consecutive tokens against the page pool.

    The paged twin of :func:`block_decode_self_attention`: token ``j`` of
    slot ``b`` lives at local position ``local_pos[b] + j`` of its own page
    run, RoPE rotates by that unclamped position and query ``j`` attends
    over local rows ``<= local_pos[b] + j``. Writes scatter IN PLACE
    through the table; a position outside ``[0, S)`` is dropped (see
    :func:`_block_write_rows`), never clamped onto a real row.

    One ``index_put_`` orders duplicate indices arbitrarily on CUDA. The
    caller gives every lane its own pages (empty and self-masked lanes
    carry their own scratch page), so lanes never share a row; within a
    lane, ``m <= ps`` consecutive positions fall on distinct offsets, and
    a longer block is written in runs of ``ps`` positions, in order.

    Returns (out [B, m, d], cache_k, cache_v), the caches being the same
    tensors.
    """
    B, m, _ = x.shape
    ps = pages.page_size
    table = pages.table.long()
    n_pages = table.shape[1]
    S = n_pages * ps
    q = reshape(linear(params["wq"], x), B, m, n_heads, head_dim)
    k = reshape(linear(params["wk"], x), B, m, n_kv, head_dim)
    v = reshape(linear(params["wv"], x), B, m, n_kv, head_dim)
    posb = pages.local_pos.long()[:, None] + torch.arange(m, device=x.device)
    inv_freq = rope_freqs(head_dim, rope_theta, device=x.device)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    last_page = table[:, -1]
    rows, k_w, v_w = _block_write_rows(posb, S, k, v,
                                       cache_k[last_page, ps - 1],
                                       cache_v[last_page, ps - 1])
    page_ids = table.gather(1, rows // ps)
    offs = rows % ps
    for j in range(0, m, ps):
        cache_k[page_ids[:, j:j + ps], offs[:, j:j + ps]] = k_w[:, j:j + ps]
        cache_v[page_ids[:, j:j + ps], offs[:, j:j + ps]] = v_w[:, j:j + ps]
    k_all = reshape(cache_k[table], B, S, n_kv, head_dim)
    v_all = reshape(cache_v[table], B, S, n_kv, head_dim)
    # query j of slot b sees exactly local rows [0, local_pos[b] + j]
    kv_valid = (torch.arange(S, device=x.device)[None, None, :]
                <= posb[:, :, None])
    o = mha(q, k_all, v_all, causal=False, kv_valid=kv_valid)
    out = linear(params["wo"], reshape(o, B, m, n_heads * head_dim))
    return out, cache_k, cache_v
