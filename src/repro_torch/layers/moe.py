"""Mixture-of-Experts with sort-based dispatch (the reference's
``layers/moe.py``), on one card.

Routing follows Mixtral/Phi-3.5: a softmax router in fp32, top-k, gates
renormalised over the k picks, and the switch-style load-balance auxiliary
loss. Dispatch is the sort + capacity formulation: the token-expert
assignments sorted by expert (a stable sort), a fixed capacity of slots
per expert, overflow dropped. Each expert's SwiGLU runs as one batched
product over its slots, and the outputs, scaled by their gates, are added
back to their tokens in fp32.

Under a sharding context the reference's expert-parallel constraints
apply (``shard_act``). DTensor has no sharding rule for the sort,
``searchsorted`` or the scatter-add, so the dispatch, the slot gather and
the combine run on replicated local tensors (``on_replicated``: a
divergence, the reference's GSPMD partitions them itself); the expert
products stay on the sharded weights. No TPU kernel lies on this path: it
is plain torch, with every product summed in fp32 as the reference's
``preferred_element_type`` asks. The reference's ungated expert variant
(``gated=False``) has no caller and is not carried.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import on_replicated, reshape, shard_act
from repro_torch.layers.linear import bmm_f32


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``ceil(T k cf / E)`` padded to a multiple of 8,
    at least 8 (the reference's ``_capacity``)."""
    c = int(-(-n_tokens * top_k * capacity_factor // n_experts))
    return max(8, -(-c // 8) * 8)


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens ``xf`` [G, T, d] (G groups).

    Returns ``(gate_vals [G, T, k] fp32, expert_ids [G, T, k], aux)``:
    the renormalised gates of each token's k experts, highest first, and
    the switch aux loss ``E * sum(mean prob * mean assignment share)``
    over all tokens."""
    n_experts = router.shape[-1]
    logits = torch.matmul(xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_ids, n_experts).float().mean(dim=(0, 1, 2))
    return gate_vals, expert_ids, n_experts * torch.sum(me * ce)


def dispatch(expert_ids: torch.Tensor, gate_vals: torch.Tensor,
             n_experts: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort-based dispatch of each group's assignments.

    ``expert_ids`` and ``gate_vals`` [G, T, k]; ``cap`` slots per expert.
    The T k assignments of a group are sorted by expert, stably (in token
    order within an expert), and expert e's slots take its first ``cap``.
    Returns ``(tok, valid, gate)``, each [G, E, cap]: the token in each
    slot, whether the slot holds an assignment (a False slot is empty or
    past the expert's count; its ``tok`` is arbitrary), and its gate (0 in
    an invalid slot)."""
    G, T, k = expert_ids.shape
    n = T * k
    dev = expert_ids.device
    flat_e = expert_ids.reshape(G, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=dev)
    starts = torch.searchsorted(sorted_e,
                                experts.expand(G, n_experts).contiguous())
    slots = starts[:, :, None] + torch.arange(cap, device=dev)   # [G, E, C]
    in_range = slots < n
    slots_c = slots.clamp(max=n - 1).reshape(G, -1)
    e_at = torch.gather(sorted_e, 1, slots_c).view(G, n_experts, cap)
    valid = in_range & (e_at == experts[:, None])
    pair = torch.gather(order, 1, slots_c)                        # [G, E*C]
    gate = torch.gather(gate_vals.reshape(G, n), 1, pair)
    gate = torch.where(valid, gate.view(G, n_experts, cap), 0.0)
    return pair.view(G, n_experts, cap) // k, valid, gate


def expert_ffn(params: Mapping[str, torch.Tensor], xe: torch.Tensor,
               gate: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its slots ``xe`` [G, E, C, d], scaled by
    ``gate`` [G, E, C]: fp32 [G, E, C, d]. The gate and up products are
    fp32, their SwiGLU is rounded to x's dtype, and the down product is
    fp32 again (the reference's ``moe`` and ``_expert_ffn``). With one
    group the slots and the SwiGLU are laid out as the reference's global
    ``moe`` lays its [E, C, ...] tensors (experts, then capacity), with
    several as its ``moe_grouped`` lays [G, E, C, d]."""
    G, E, C, d = xe.shape
    if G > 1:
        xe = shard_act(xe, "batch", "experts", None, None)
    xs = reshape(xe.transpose(0, 1), E, G * C, d)
    if G == 1:
        xs = shard_act(xs, "experts", "expert_cap", None)
    g = bmm_f32(xs, params["w_gate"])
    u = bmm_f32(xs, params["w_up"])
    h = (F.silu(g) * u).to(xe.dtype)
    if G == 1:
        h = shard_act(h, "experts", "expert_cap", None)
    ye = reshape(bmm_f32(h, params["w_down"]), E, G, C, d).transpose(0, 1)
    return ye * gate[..., None]


def _gather_slots(xf: torch.Tensor, tok: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The tokens of every slot, [G, E, C, d], zero in an invalid slot."""
    rows = torch.arange(xf.shape[0], device=xf.device)[:, None, None]
    return xf[rows, tok].masked_fill(~valid[..., None], 0)


def _combine(ye: torch.Tensor, tok: torch.Tensor, Tg: int) -> torch.Tensor:
    """Each slot's output ``ye`` [G, E, C, d] added back in fp32 to its
    token ``tok`` [G, E, C] of the group's ``Tg``: [G * Tg, d]."""
    G, d = ye.shape[0], ye.shape[-1]
    rows = torch.arange(G, device=ye.device)[:, None, None]
    y = torch.zeros(G * Tg, d, dtype=torch.float32, device=ye.device)
    y.index_add_(0, (tok + Tg * rows).reshape(-1), ye.reshape(-1, d))
    return y


def moe(params: Mapping[str, torch.Tensor], x: torch.Tensor, *,
        n_experts: int, top_k: int, capacity_factor: float = 1.25,
        n_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of x [B, S, d]: ``(y [B, S, d] in x's dtype, aux)``.

    ``params`` holds ``router`` [d, E] and the stacked expert weights
    ``w_gate``/``w_up`` [E, d, f] and ``w_down`` [E, f, d]. With
    ``n_groups`` G > 1 (and B S divisible into groups of at least
    ``top_k`` tokens) the tokens split into G groups that route, sort and
    combine alone, each with its own capacity (the reference's
    ``moe_grouped``); otherwise all B S tokens form one group (``moe``).
    """
    B, S, d = x.shape
    T = B * S
    G = n_groups if (n_groups > 1 and T % n_groups == 0
                     and T // n_groups >= top_k) else 1
    Tg = T // G
    xf = reshape(x, G, Tg, d)
    if G > 1:
        xf = shard_act(xf, "batch", None, None)
    gate_vals, expert_ids, aux = route(params["router"], xf, top_k)
    cap = capacity(Tg, top_k, n_experts, capacity_factor)
    tok, valid, gate = on_replicated(dispatch, expert_ids, gate_vals,
                                     n_experts, cap)
    xe = on_replicated(_gather_slots, xf, tok, valid)          # [G,E,C,d]
    ye = expert_ffn(params, xe, gate)
    y = on_replicated(_combine, ye, tok, Tg)
    y = reshape(y, B, S, d).to(x.dtype)
    return shard_act(y, "batch", "seq", "act_embed"), aux
