"""Plain torch attention: the flash kernel's plain version and oracle."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,   # [BH, Sq, hd]
    k: torch.Tensor,   # [BH, Sk, hd]
    v: torch.Tensor,   # [BH, Sk, hd]
    *,
    causal: bool = True,
    q_start: int = 0,
) -> torch.Tensor:
    """softmax(mask(q @ k^T * hd**-0.5)) @ v in fp32, cast to q's dtype.

    Causal masking admits key ``j`` for query row ``i`` when
    ``j <= q_start + i``; masked scores are set to -1e30.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qi = q_start + torch.arange(Sq, device=q.device)
        mask = torch.arange(Sk, device=q.device)[None, :] <= qi[:, None]
        s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
