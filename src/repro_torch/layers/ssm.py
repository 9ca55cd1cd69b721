"""Mamba2 selective state-space layer (the SSD chunked algorithm).

Prefill uses the chunked SSD formulation (Dao & Gu 2024, "minimal SSD"):
the sequence splits into chunks, interactions within a chunk are a masked
decay product, and the state flows across chunks through a short loop
over chunk index (the reference's ``lax.scan``). Decode is the O(1)
recurrent state update. As in the reference: ngroups = 1 (B and C shared
across heads), and the causal conv runs on the x branch only.

No TPU kernel lies on this path; it is plain torch, with the reference's
dtypes step by step: the conv in the activation dtype with its SiLU in
fp32, the SSD entirely in fp32, ``y`` cast back before the gate.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import reshape, shard_act
from repro_torch.layers.linear import linear
from repro_torch.layers.norm import rmsnorm

D_CONV = 4      # conv taps; the decode state keeps the last D_CONV - 1 rows


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as the reference computes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence: x [B, L, D], w [K, D].

    ``state`` [B, K-1, D] is the trailing context (zeros without it).
    Returns ``(silu(y), new_state)``: the taps are summed in x's dtype,
    tap 0 first, the SiLU runs in fp32; ``new_state`` is the last K-1 rows
    of the padded input.
    """
    K = w.shape[0]
    L = x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                      # [B, L+K-1, D]
    y = xp[:, 0:L] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + L] * w[i]
    y = y + b
    new_state = xp[:, -(K - 1):]
    return F.silu(y.float()).to(x.dtype), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., L] -> [..., L, L] lower-triangular segment sums:
    ``out[i, j] = sum(a[j+1..i])``, ``-inf`` above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,        # [B, L, H, P] (dt already folded in)
    dA: torch.Tensor,       # [B, L, H]   per-step log decay (dt * A, < 0)
    Bmat: torch.Tensor,     # [B, L, N]
    Cmat: torch.Tensor,     # [B, L, N]
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,    # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: ``y[t] = C_t . h_t``, ``h_t = exp(dA_t) h_{t-1} + B_t
    x_t``, all in fp32. Returns ``(y [B, L, H, P], final state [B, H, P,
    N])``. A ``chunk`` that does not divide L becomes L (one chunk).

    The reference's four-operand intra-chunk einsum ``bcln,bcsn,bhcls,
    bcshp->bclhp`` runs here as two contractions, in this order: ``C . B``
    over the state dim, times the decay mask, then against x over the
    source position. Its three-operand einsums fold the decay factor into
    one operand first.
    """
    B, L, H, P = x.shape
    N = Bmat.shape[-1]
    if L % chunk:
        chunk = L                    # degenerate small-sequence case
    nC = L // chunk
    xc = reshape(x, B, nC, chunk, H, P).float()
    dAc = reshape(dA, B, nC, chunk, H).permute(0, 3, 1, 2).float()  # B,H,C,Lc
    Bc = reshape(Bmat, B, nC, chunk, N).float()
    Cc = reshape(Cmat, B, nC, chunk, N).float()

    Acs = torch.cumsum(dAc, dim=-1)                            # [B,H,C,Lc]
    Lmat = torch.exp(_segsum(dAc))                             # [B,H,C,Lc,Lc]

    # intra-chunk (diagonal blocks)
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    w = cb[:, None] * Lmat                                     # [B,H,C,l,s]
    y_diag = torch.einsum("bhcls,bcshp->bclhp", w, xc)

    # per-chunk final states [B, C, H, P, N]
    decay_states = torch.exp(Acs[..., -1:] - Acs)              # [B,H,C,Lc]
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]      # [B,C,Lc,H,P]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xd)

    # inter-chunk recurrence, a loop over chunk index
    chunk_decay = torch.exp(Acs[..., -1])                      # [B,H,C]
    if init_state is None:
        s = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    else:
        s = init_state.float()
    prev = []
    for c in range(nC):
        prev.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=2)                     # [B,H,C,P,N]

    # inter-chunk contribution
    y_off = torch.einsum("bcln,bhcpn->bclhp", Cc, prev_states)
    y_off = y_off * torch.exp(Acs).permute(0, 2, 3, 1)[..., None]
    y = reshape(y_diag + y_off, B, L, H, P)
    return y, s


def _gate_norm_out(params: Mapping, y: torch.Tensor, z: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The gated RMS norm ``norm(y * silu(z))`` and the out projection."""
    y = y * F.silu(z.float()).to(x.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y)
    return linear(params["out"], y)


def mamba2(params: Mapping, x: torch.Tensor, *, head_dim: int = 64,
           d_state: int = 64, chunk: int = 128) -> torch.Tensor:
    """The full Mamba2 block over ``x`` [B, L, d_model] (prefill)."""
    B, L, _ = x.shape
    z = linear(params["wz"], x)                           # [B, L, d_inner]
    xi = linear(params["wx"], x)
    d_inner = xi.shape[-1]
    H = d_inner // head_dim
    xi, _ = _causal_conv(xi, params["conv_w"], params["conv_b"])
    xi = shard_act(xi, "batch", "seq", "act_mlp")
    Bmat, Cmat = linear(params["wBC"], x).float().chunk(2, dim=-1)
    dt = _softplus(linear(params["wdt"], x).float()
                   + params["dt_bias"].float())          # [B, L, H]
    A = -torch.exp(params["A_log"].float())               # [H]
    xh = reshape(xi, B, L, H, head_dim)
    xdt = xh.float() * dt[..., None]
    y, _ = ssd_chunked(xdt, dt * A, Bmat, Cmat, chunk=chunk)
    y = y + params["D"].float()[:, None] * xh.float()
    y = reshape(y, B, L, d_inner).to(x.dtype)
    return _gate_norm_out(params, y, z, x)


def mamba2_state_spec(batch: int, n_layers: int, d_inner: int,
                      head_dim: int, d_state: int, d_conv: int = D_CONV
                      ) -> dict:
    """Shapes of the decode state of ``n_layers`` Mamba2 layers (fp32,
    zero-initialised): ``ssm`` [L, B, H, P, N] and ``conv`` [L, B,
    d_conv - 1, d_inner]."""
    H = d_inner // head_dim
    return {"ssm": (n_layers, batch, H, head_dim, d_state),
            "conv": (n_layers, batch, d_conv - 1, d_inner)}


def mamba2_decode(params: Mapping, x: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, *, head_dim: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One recurrent decode step: ``x`` [B, 1, d_model], ``ssm_state`` [B,
    H, P, N] fp32, ``conv_state`` [B, K-1, d_inner] (stored in fp32, cast
    to x's dtype on entry). Returns ``(y [B, 1, d_model], new ssm state
    fp32, new conv state fp32)``; the inputs are not written."""
    B = x.shape[0]
    z = linear(params["wz"], x)
    xi = linear(params["wx"], x)
    d_inner = xi.shape[-1]
    H = d_inner // head_dim
    xi, conv_state = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                  state=conv_state.to(x.dtype))
    Bmat, Cmat = linear(params["wBC"], x).float().chunk(2, dim=-1)  # [B,1,N]
    dt = _softplus(linear(params["wdt"], x).float()
                   + params["dt_bias"].float())[:, 0]     # [B, H]
    A = -torch.exp(params["A_log"].float())
    xh = reshape(xi, B, H, head_dim).float()
    dA = torch.exp(dt * A)                                # [B, H]
    new_state = (ssm_state.float() * dA[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xh * dt[..., None],
                                Bmat[:, 0]))
    y = torch.einsum("bhpn,bn->bhp", new_state, Cmat[:, 0])
    y = y + params["D"].float()[:, None] * xh
    y = reshape(y, B, 1, d_inner).to(x.dtype)
    return _gate_norm_out(params, y, z, x), new_state, conv_state.float()
