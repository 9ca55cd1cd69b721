"""RWKV6 ("Finch") attention-free time mixing with data-dependent decay
(the reference's ``layers/rwkv.py``).

The state per head is a P x P matrix. Prefill runs the recurrence token by
token; decode is the same update for one token, so the state is O(1) per
layer. As in the reference: static per-channel token-shift mixes (the
ddlerp LoRA collapsed to ``mu``) and a single-layer tanh decay LoRA.

No TPU kernel lies on this path; it is plain torch, with the reference's
dtypes step by step: projections in the activation dtype with fp32
accumulation, the decay and the wkv recurrence in fp32, the group norm's
output in the activation dtype. The reference's two-level (chunked) scan
performs the same per-step operations as its flat scan and only changes
what its backward pass keeps, so the port runs one flat loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.layers.linear import linear
from repro_torch.layers.norm import groupnorm_heads


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The previous-token stream of x [B, S, D]: x shifted by one, with
    ``prev`` [B, D] (zeros without it) at t = 0."""
    if prev is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xprev: torch.Tensor,
         mu: torch.Tensor) -> torch.Tensor:
    return x + mu.to(x.dtype) * (xprev - x)


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    """The per-channel decay ``exp(-exp(w0 + lora(xw)))`` in (0, 1), fp32."""
    lora = torch.tanh(linear(params["w_lora_a"], xw).float())
    lora = torch.matmul(lora, params["w_lora_b"]["w"].float())
    return torch.exp(-torch.exp(params["w0"].float() + lora))


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence over r, k, v, w [B, T, H, P] fp32 with the bonus
    u [H, P], from ``state`` [B, H, P, P] (zeros without it):

        y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S + k v^T

    Returns ``(y [B, T, H, P], S_T)``, both fp32. The bonus term
    ``(r_t . (u * k_t)) v_t`` needs no state, so it runs for every step at
    once outside the loop, which keeps three batched products per step on
    the host's critical path (the reference's sum, regrouped: fp32
    rounding apart, the same values)."""
    B, T, H, P = r.shape
    S = (torch.zeros((B * H, P, P), dtype=torch.float32, device=r.device)
         if state is None else state.reshape(B * H, P, P))
    bonus = torch.sum(r * u * k, dim=-1, keepdim=True) * v
    # [T, B*H, P] so that each step reads contiguous rows
    rt, kt, vt, wt = (a.permute(1, 0, 2, 3).reshape(T, B * H, P)
                      for a in (r, k, v, w))
    ys = []
    for t in range(T):
        ys.append(torch.bmm(rt[t, :, None, :], S))
        S = torch.baddbmm(wt[t, :, :, None] * S, kt[t, :, :, None],
                          vt[t, :, None, :])
    y = torch.cat(ys, dim=1).view(B * H, T, P)
    y = y.view(B, H, T, P).transpose(1, 2) + bonus
    return y, S.view(B, H, P, P)


def rwkv6_time_mix(params, x: torch.Tensor, *, head_dim: int = 64,
                   tm_prev: Optional[torch.Tensor] = None,
                   wkv_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """The time mix of x [B, S, D]. ``tm_prev`` [B, D] is the token before
    x (the carried last input) and ``wkv_state`` [B, H, P, P] the carried
    wkv state. With ``return_state`` returns ``(out, x[:, -1], new
    wkv state)``, else ``out`` [B, S, D] in x's dtype."""
    B, S, D = x.shape
    H = D // head_dim
    xprev = _token_shift(x, tm_prev)
    xr, xk, xv, xw, xg = (_mix(x, xprev, params[f"mu_{n}"])
                          for n in ("r", "k", "v", "w", "g"))
    r = linear(params["wr"], xr).view(B, S, H, head_dim)
    k = linear(params["wk"], xk).view(B, S, H, head_dim)
    v = linear(params["wv"], xv).view(B, S, H, head_dim)
    g = linear(params["wg"], xg)
    w = _decay(params, xw).view(B, S, H, head_dim)
    y, new_state = wkv_scan(r.float(), k.float(), v.float(), w,
                            params["u"].float(), wkv_state)
    y = groupnorm_heads(y.to(x.dtype), params["ln_x_scale"],
                        params["ln_x_bias"])
    y = y.reshape(B, S, D) * F.silu(g.float()).to(x.dtype)
    out = linear(params["wo"], y)
    if return_state:
        return out, x[:, -1, :], new_state
    return out


def rwkv6_channel_mix(params, x: torch.Tensor, *,
                      cm_prev: Optional[torch.Tensor] = None,
                      return_state: bool = False):
    """The channel mix of x [B, S, D], ``cm_prev`` [B, D] the token before
    x: ``sigmoid(x_r Wr) * (relu(x_k Wk)^2 Wv)``. With ``return_state``
    returns ``(out, x[:, -1])``."""
    xprev = _token_shift(x, cm_prev)
    xk = _mix(x, xprev, params["mu_ck"])
    xr = _mix(x, xprev, params["mu_cr"])
    k = linear(params["ck"], xk)
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = linear(params["cv"], k)
    out = torch.sigmoid(linear(params["cr"], xr).float()).to(x.dtype) * kv
    if return_state:
        return out, x[:, -1, :]
    return out
