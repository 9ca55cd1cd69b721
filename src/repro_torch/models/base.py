"""Model API of the port: the architecture config, the shape table, the
decode LM head and the family dispatch.

A jax-free copy of ``repro.models.base`` for the families the port
carries (the dense decoder LM). There is no ``ParamSpec``: a model is an
``nn.Module`` that owns its parameters, in the reference's layout
(weights ``(d_in, d_out)``, so ``x @ w`` needs no transpose).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.emit import DeviceLike
from repro_torch.layers.linear import matmul_f32, quantized_linear


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | encdec | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_groups: int = 0
    # vlm: one cross-attn layer per `cross_attn_every`
    cross_attn_every: int = 0
    n_image_tokens: int = 4096
    # enc-dec: encoder depth; decoder length = seq // dec_ratio
    n_enc_layers: int = 0
    dec_ratio: int = 4
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0
    is_rwkv: bool = False
    # execution
    sharding_mode: str = "megatron"
    microbatches: int = 1
    remat: bool = True
    q_chunk: int = 512
    ssd_chunk: int = 128
    optimizer: str = "adamw"
    quantized: bool = False      # serve: int8 qmatmul LM head (--quantized)
    # serve: also route the MLP down-projection through the qmatmul kernel
    # (a16w8: int16 activations, int8 weights, int16 SRS out), with shifts
    # calibrated per tensor by repro_torch.plan.passes.calibrate_mlp_shifts;
    # the defaults are the analytic fallback for silu-gated activations on
    # unit-RMS inputs
    quantized_mlp: bool = False
    mlp_x_shift: int = 11
    mlp_w_shift: int = 8
    mlp_out_shift: int = 11
    notes: str = ""

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Decode LM-head shifts: rmsnorm'd activations (absmax < 4 -> x_shift 5),
# fan-in-scaled head weights (absmax < 0.5 -> w_shift 8), int16 SRS out
# with ~5e-4 logit resolution over +-16 (out_shift 11).
HEAD_SHIFTS = (5, 8, 11)

PORTED_FAMILIES = ("dense",)


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16):
    """The family's model with uninitialised parameters on ``device``
    (default: the card). Only the dense decoder LM is ported."""
    if cfg.family == "dense":
        from repro_torch.models.lm import DecoderLM

        return DecoderLM(cfg, device=device, dtype=dtype)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 12: "
        "the other families); the port carries "
        f"{', '.join(PORTED_FAMILIES)}")


def decode_head_logits(head_w: torch.Tensor, x: torch.Tensor,
                       cfg: ArchConfig,
                       head_wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-token logits [B, V] in fp32 from decode hiddens ``x`` [B, 1, d].

    With ``cfg.quantized`` the projection routes through the qmatmul kernel
    (int8 operands, int16 SRS output) at :data:`HEAD_SHIFTS`; ``head_wq``
    is ``head_w`` already quantized at the head's w_shift (the same bits
    as quantizing it here). Logit gaps below the ~0.05 quantization noise
    can flip the argmax against the float path: that is the int8 contract.
    """
    if cfg.quantized:
        x_shift, w_shift, out_shift = HEAD_SHIFTS
        return quantized_linear(
            {"w": head_w}, x[:, 0],
            x_shift=x_shift, w_shift=w_shift, out_shift=out_shift,
            out_dtype="int16", out_float_dtype=torch.float32, wq=head_wq,
        )
    return matmul_f32(x, head_w)[:, 0]
