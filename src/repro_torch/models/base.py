"""Model API of the port: the architecture config, the shape table, the
decode LM head and the family dispatch.

A jax-free copy of ``repro.models.base`` for every family of the
reference (the dense and MoE decoder LMs, RWKV, the hybrid, the
encoder-decoder and the vision LM). A model is an ``nn.Module`` that owns
its parameters, in the reference's layout (weights ``(d_in, d_out)``, so
``x @ w`` needs no transpose), and :class:`PortedLM` holds what the
families share. ``PortedLM.param_specs()`` gives the reference's
``ParamSpec`` of every leaf (stacked shape, logical axes, dtype), read
off the parameters through :func:`leaf_logical`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.emit import DeviceLike
from repro_torch.dist.sharding import ParamSpec, shard_act
from repro_torch.layers.linear import (
    matmul_f32,
    quantize_weight,
    quantized_linear,
)
from repro_torch.layers.remat import remat


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

# long_500k needs sub-quadratic attention: only the SSM and hybrid families
# run it (the reference's skip list)
_LONG_OK_FAMILIES = ("ssm", "hybrid")

InputSpecs = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def supports_shape(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """``(ok, reason)``: whether ``cfg``'s family runs the SHAPES cell
    ``shape``, with the reference's reason when it does not."""
    if shape == "long_500k" and cfg.family not in _LONG_OK_FAMILIES:
        return False, (
            "pure full-attention architecture: 500k-token decode would need "
            "sub-quadratic attention (skip noted in DESIGN.md)"
        )
    return True, ""


def token_input_specs(batch: int, seq: int) -> InputSpecs:
    """``tokens`` and ``labels`` [batch, seq] int32, as (shape, dtype)."""
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}


def decode_input_specs(batch: int) -> InputSpecs:
    """One decode step's inputs: ``tokens`` [batch] and the scalar
    ``pos``, int32."""
    return {"tokens": ((batch,), torch.int32), "pos": ((), torch.int32)}


# Decode LM-head shifts: rmsnorm'd activations (absmax < 4 -> x_shift 5),
# fan-in-scaled head weights (absmax < 0.5 -> w_shift 8), int16 SRS out
# with ~5e-4 logit resolution over +-16 (out_shift 11).
HEAD_SHIFTS = (5, 8, 11)


def prefill_inputs(cfg: ArchConfig, shape: ShapeSpec
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The batch a prefill of ``shape`` feeds ``forward``, by name: its
    shape and dtype (the reference's ``input_specs`` without the labels).
    Every family takes ``tokens`` [B, S]; the encoder-decoder takes frame
    embeddings ``frames`` [B, S, d] and a decoder run of ``max(S //
    dec_ratio, 128)`` tokens, the vision LM patch embeddings ``vision``
    [B, n_image_tokens, d] beside its tokens (the audio and vision
    frontends are stubs, as in the reference)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": ((B, S, cfg.d_model), torch.bfloat16),
                "tokens": ((B, max(S // cfg.dec_ratio, 128)), torch.int32)}
    inputs = {"tokens": ((B, S), torch.int32)}
    if cfg.family == "vlm":
        inputs["vision"] = ((B, cfg.n_image_tokens, cfg.d_model),
                            torch.bfloat16)
    return inputs


def train_inputs(cfg: ArchConfig, shape: ShapeSpec
                 ) -> Dict[str, Tuple[int, ...]]:
    """The shapes of a training batch at ``shape``, by name: the prefill
    inputs (``prefill_inputs``) and ``labels`` shaped as ``tokens`` (the
    reference's ``input_specs`` for a train shape)."""
    want = {name: s for name, (s, _) in prefill_inputs(cfg, shape).items()}
    want["labels"] = want["tokens"]
    return want


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def pending_item(family: str) -> str:
    """The roadmap item that ports ``family`` (for error messages): every
    family of the reference is ported, so only an unknown one gets here."""
    return f"no roadmap item: unknown family {family!r}"


class PageView(NamedTuple):
    """The paged KV layout as one decode step sees it.

    ``table`` [B, max_len // page_size] int32 maps each slot's logical
    page index to a physical page of the shared pool; ``local_pos`` [B]
    int32 is each slot's position in its OWN sequence (RoPE and cache
    indexing both use it, which makes a page's contents a function of the
    token prefix it encodes and so reusable across slots); ``page_size``
    is a host int. See ``docs/memory_model.md``.
    """

    table: torch.Tensor
    local_pos: torch.Tensor
    page_size: int


# Decode-state leaves that move to the paged layout: the self-attention KV
# caches, [L, B, max_len, KV, hd] dense or [L, page_count, page_size, KV,
# hd] in the shared pool.
PAGED_STATE_KEYS = ("cache_k", "cache_v")

# The cross-attention caches of the encoder-decoder and the vision LM: the
# memory's keys and values, per slot (batch on axis 1) and never paged.
CROSS_STATE_KEYS = ("cross_k", "cross_v")

# Prefix of the speculative draft's KV twins in a merged decode state.
DRAFT_PREFIX = "draft_"


def is_paged_state_key(name: str) -> bool:
    """True for leaves that live in the shared page pool: the KV caches and
    their ``draft_`` twins (the draft's KV rides the same page tables: one
    page id indexes both pools at matching local positions)."""
    if name.startswith(DRAFT_PREFIX):
        name = name[len(DRAFT_PREFIX):]
    return name in PAGED_STATE_KEYS


def paged_state_specs(sspecs: Mapping[str, ParamSpec], page_count: int,
                      page_size: int) -> Dict[str, ParamSpec]:
    """The reference's ``paged_state_specs``: every self-attention KV leaf
    (and its ``draft_`` twin) ``[..., batch, max_len, KV, hd]`` becomes the
    shared pool ``[..., page_count, page_size, KV, hd]``, both new axes
    replicated (logical None: pages are shared between slots and buckets),
    head and head-dim axes kept; every other leaf passes as it is."""
    out = {}
    for name, s in sspecs.items():
        if not is_paged_state_key(name):
            out[name] = s
            continue
        b = s.logical.index("batch")
        q = s.logical.index("seq")
        if q != b + 1:
            raise ValueError(f"{name}: batch and seq axes not adjacent in "
                             f"{s.logical}")
        shape = s.shape[:b] + (page_count, page_size) + s.shape[q + 1:]
        logical = s.logical[:b] + (None, None) + s.logical[q + 1:]
        out[name] = ParamSpec(shape, logical, s.dtype, "zeros")
    return out


def spec_state_specs(sspecs: Mapping[str, ParamSpec], draft_layers: int,
                     prefix: str = DRAFT_PREFIX) -> Dict[str, ParamSpec]:
    """The reference's ``spec_state_specs``: a ``draft_`` twin of every
    leaf, its first "layers" dim cut to ``draft_layers`` (the KV of the
    layer-prefix draft)."""
    out = {}
    for name, s in sspecs.items():
        li = s.logical.index("layers")
        shape = s.shape[:li] + (draft_layers,) + s.shape[li + 1:]
        out[prefix + name] = ParamSpec(shape, s.logical, s.dtype, s.init)
    return out


def state_specs(model, batch: int, max_len: int,
                paged: Optional[Tuple[int, int]] = None,
                only: Optional[str] = None,
                draft_layers: int = 0) -> Dict[str, ParamSpec]:
    """The specs of the state ``model.decode_state`` allocates for the same
    arguments, in the reference's layout: ``decode_state_specs``, the
    draft's twins (``spec_state_specs``) and the page pool
    (``paged_state_specs``), ``only`` picking the pool or the per-slot
    half, as the reference's ``fresh_decode_state`` builds them."""
    sspecs = model.decode_state_specs(batch, max_len)
    if draft_layers:
        sspecs = dict(sspecs, **spec_state_specs(sspecs, draft_layers))
    if paged is not None:
        sspecs = paged_state_specs(sspecs, *paged)
        if only is not None:
            sspecs = {k: s for k, s in sspecs.items()
                      if is_paged_state_key(k) == (only == "pool")}
    return sspecs


def port_layout(spec: ParamSpec, shape: Tuple[int, ...]) -> ParamSpec:
    """``spec`` laid out as the port's leaf of ``shape``: where the port
    flattens the reference's leading stacked dims (the hybrid's ``[G, E,
    ...]`` SSM and conv states, the vision LM's ``[n_super,
    self_per_block, ...]`` KV caches) their "layers" axes merge into one,
    which no mode shards; raises if the shapes do not agree."""
    n = len(spec.shape) - len(shape)
    if n > 0 and spec.logical[:n + 1] == ("layers",) * (n + 1):
        lead = 1
        for size in spec.shape[:n + 1]:
            lead *= size
        spec = ParamSpec((lead,) + spec.shape[n + 1:],
                         ("layers",) + spec.logical[n + 1:], spec.dtype,
                         spec.init)
    if tuple(spec.shape) != tuple(shape):
        raise ValueError(f"state spec {spec.shape} does not lay out a leaf "
                         f"of shape {tuple(shape)}")
    return spec


def split_spec_state(state: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """Split a merged speculative state into ``(target, draft)``.

    Both are new dicts over the SAME tensors (no copy), so a step that
    writes either half in place writes the merged state. The draft's keys
    lose their prefix, so one ``decode_block`` consumes either half.
    """
    target = {k: v for k, v in state.items()
              if not k.startswith(DRAFT_PREFIX)}
    draft = {k[len(DRAFT_PREFIX):]: v for k, v in state.items()
             if k.startswith(DRAFT_PREFIX)}
    return target, draft


def state_batch_axes(state: Mapping[str, torch.Tensor],
                     paged: bool) -> Dict[str, int]:
    """Per-leaf index of the batch axis of a decode state.

    Every batch-laned leaf of the port's states is ``[L, B, ...]`` (axis
    1): the KV caches, the cross-attention caches, RWKV's carried inputs
    and wkv state, and the hybrid's SSM and conv states, whose reference
    ``[G, E, B, ...]`` layout the port flattens to ``[G * E, B, ...]``, as
    it flattens the vision LM's ``[n_super, self_per_block, B, ...]`` KV
    caches. With ``paged`` the pool leaves have a page axis instead and map
    to ``-1``: they need no per-slot wipe, since stale pages are invisible
    behind the local-position mask, and :func:`wipe_state_slots` skips
    them.
    """
    return {name: -1 if paged and is_paged_state_key(name) else 1
            for name in state}


def wipe_state_slots(state: Mapping[str, torch.Tensor],
                     slot_mask: torch.Tensor,
                     batch_axes: Mapping[str, int]) -> None:
    """Zero the masked batch lanes of every leaf in place.

    ``slot_mask`` is a [B] bool tensor on the state's device; the zeroing
    is one masked fill per leaf, so it never waits for the device. Leaves
    whose axis is ``-1`` (the shared page pool) are left untouched. Raises
    if a leaf's batch axis does not have ``slot_mask``'s length (a leaf
    laid out with its batch elsewhere would otherwise wipe the wrong
    lanes, or broadcast the mask over another axis).
    """
    for name, leaf in state.items():
        axis = batch_axes[name]
        if axis < 0:
            continue
        if leaf.dim() <= axis or leaf.shape[axis] != slot_mask.shape[0]:
            raise ValueError(
                f"state leaf {name!r} of shape {tuple(leaf.shape)} has no "
                f"batch axis {axis} of {slot_mask.shape[0]} lanes")
        shape = [1] * leaf.dim()
        shape[axis] = slot_mask.shape[0]
        leaf.masked_fill_(slot_mask.view(shape), 0)


def model_class(family: str) -> type:
    """The port's model class of a family (the reference's
    ``build_model`` table); raises for a family the port does not carry."""
    if family in ("dense", "moe"):
        from repro_torch.models.lm import DecoderLM

        return DecoderLM
    if family == "ssm":
        from repro_torch.models.rwkv_model import RWKVModel

        return RWKVModel
    if family == "hybrid":
        from repro_torch.models.hybrid import HybridModel

        return HybridModel
    if family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM
    if family == "vlm":
        from repro_torch.models.vision_lm import VisionLM

        return VisionLM
    raise NotImplementedError(
        f"family {family!r} is not ported yet ({pending_item(family)}); "
        f"the port carries {', '.join(PORTED_FAMILIES)}")


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16):
    """The family's model with uninitialised parameters on ``device``
    (default: the card)."""
    return model_class(cfg.family)(cfg, device=device, dtype=dtype)


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


def decode_block_head_logits(head_w: torch.Tensor, x: torch.Tensor,
                             cfg: ArchConfig,
                             head_wq: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Logits [B, m, V] in fp32 for a block of m decode hiddens [B, m, d].

    The block form of :func:`decode_head_logits` for speculative block
    verification, with the same shifts and the same int8 contract: the
    quantized projection is one qmatmul launch at M = B * m.
    """
    if cfg.quantized:
        x_shift, w_shift, out_shift = HEAD_SHIFTS
        return quantized_linear(
            {"w": head_w}, x,
            x_shift=x_shift, w_shift=w_shift, out_shift=out_shift,
            out_dtype="int16", out_float_dtype=torch.float32, wq=head_wq,
        )
    return matmul_f32(x, head_w)


def _chunk_ce(head_w: torch.Tensor, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token CE of one chunk: fp32 logits, logsumexp minus the
    gold logit. Under a sharding context the logits' vocab dim is
    replicated first (a port constraint the reference does not have:
    DTensor's gather over a vocab-sharded dim leaves a mask it cannot
    reduce on some meshes); outside one this is the plain product."""
    logits = shard_act(matmul_f32(x, head_w), "batch", "seq", None)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def lm_loss_chunked(head_w: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy (fp32 scalar) of the final hiddens
    ``x`` [B, S, d] against ``labels`` [B, S] through the head ``head_w``
    [d, V] (the reference's ``lm_loss_chunked``).

    Computed per sequence chunk, each chunk checkpointed, so the [B, S, V]
    fp32 logits and their gradient are never resident whole (vocab can be
    150k+); a sequence the chunk does not divide is one chunk."""
    B, S, _ = x.shape
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        total = total + remat(_chunk_ce, head_w, x[:, i:i + chunk],
                              labels[:, i:i + chunk])
    return total / (B * S)


# The reference's initialiser of each leaf, by leaf name: zeros (among
# them every bias and the vision LM's cross-attention ``gate``), ones,
# "small" (std 0.02: RWKV's token-shift mixes and per-head bonus), the
# embedding table (std d_model**-0.5), and otherwise a normal weight at
# fan-in scale.
ZERO_LEAVES = ("b", "bias", "conv_b", "dt_bias", "A_log", "w0", "ln_x_bias",
               "gate")
ONE_LEAVES = ("scale", "norm_scale", "D", "ln_x_scale")
SMALL_LEAVES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr",
                "u")
SMALL_STD = 0.02


def init_kind(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """``(kind, scale)`` of the reference's initialiser for the parameter
    ``name`` of ``shape``: kind is "zeros" or "ones" (scale is the fill
    value) or "small", "embed" or "normal" (scale is the std of a normal
    draw). A normal weight's std is its fan-in ``shape[-2] ** -0.5``
    (weights are ``(..., d_in, d_out)``, the expert axis in front), as
    ``repro.dist.sharding._fan_in`` takes it."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ZERO_LEAVES:
        return "zeros", 0.0
    if leaf in ONE_LEAVES:
        return "ones", 1.0
    if leaf in SMALL_LEAVES:
        return "small", SMALL_STD
    if name == "embed.table":
        return "embed", shape[-1] ** -0.5
    fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
    return "normal", fan_in ** -0.5


# The reference's logical axes of each leaf (``repro.layers.*_spec``),
# without its stacked dims. A linear's "w" and "b" take them from the
# linear's role in its module (``linear_axes`` / ``bias_axes``); every
# other leaf is listed by (module, name), norms aside.
LINEAR_ROLES = {
    "attn": {"wq": "col", "wk": "kv", "wv": "kv", "wo": "row"},
    "xattn": {"wq": "col", "wk": "kv", "wv": "kv", "wo": "row"},
    "ffn": {"gate": "col", "up": "col", "down": "row"},
    "shared": {"gate": "col", "up": "col", "down": "row"},
    "mamba": {"wz": "col", "wx": "col", "wBC": "replicated",
              "wdt": "replicated", "out": "row"},
    "mix": {"wr": "col", "wk": "col", "wv": "col", "wg": "col",
            "w_lora_a": "replicated", "w_lora_b": "col", "wo": "row",
            "ck": "col", "cv": "row", "cr": "replicated"},
}
LEAF_AXES = {
    ("embed", "table"): ("vocab", "embed"),
    ("head", "w"): ("embed", "vocab"),
    ("moe", "router"): (None, None),
    **{("moe", w): ("experts", "fsdp", None)
       for w in ("w_up", "w_down", "w_gate")},
    ("mamba", "conv_w"): ("conv_k", "mlp"),
    ("mamba", "conv_b"): ("mlp",),
    ("mamba", "norm_scale"): ("mlp",),
    **{("mamba", v): (None,) for v in ("dt_bias", "A_log", "D")},
    **{("mix", v): ("q_heads", None) for v in ("u", "ln_x_scale",
                                                "ln_x_bias")},
    **{("mix", v): (None,) for v in ("mu_r", "mu_k", "mu_v", "mu_w",
                                     "mu_g", "mu_ck", "mu_cr", "w0")},
}


def linear_axes(role: str, mode: str) -> Tuple[Optional[str], ...]:
    """Logical axes of a (d_in, d_out) weight for a sharding mode."""
    if mode == "cascade":
        return ("cascade_in", "cascade_out")
    return {"col": ("fsdp", "col_out"), "row": ("row_in", "fsdp"),
            "replicated": (None, None), "kv": ("fsdp", None)}[role]


def bias_axes(role: str, mode: str) -> Tuple[Optional[str], ...]:
    """Logical axes of a linear's (d_out,) bias for a sharding mode."""
    if mode == "cascade":
        return ("cascade_out",)
    return ("col_out",) if role == "col" else (None,)


def leaf_logical(path: str, mode: str) -> Tuple[Optional[str], ...]:
    """The reference's logical axes of the unstacked leaf ``path`` ("."
    joined, as ``bridge.leaf_groups`` names it) under ``mode``; raises
    ``KeyError`` for a leaf the table does not know."""
    parts = path.split(".")
    parent, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if (parent, leaf) in LEAF_AXES:
        return LEAF_AXES[(parent, leaf)]
    if leaf in ("w", "b") and len(parts) > 2:
        role = LINEAR_ROLES.get(parts[-3], {}).get(parent)
        if role is not None:
            return (linear_axes if leaf == "w" else bias_axes)(role, mode)
    if parent.startswith("ln") and leaf in ("scale", "bias"):
        return (None,)
    if leaf == "gate":                  # the vision LM's tanh gate, (1,)
        return (None,)
    raise KeyError(f"no logical axes for the leaf {path!r}")


def leaf_key(path: str) -> str:
    """The reference's ``jax.tree_util.keystr`` of the leaf ``path``:
    ``"blocks.attn.wq.w"`` -> ``"['blocks']['attn']['wq']['w']"``."""
    return "".join(f"['{p}']" for p in path.split("."))


class PortedLM:
    """What the port's LM families share, mixed into their ``nn.Module``:
    seeded initialisation, the int8 copies of the LM head and of every
    SwiGLU down-projection, and the decode head.

    A model sets ``cfg``, ``embed`` and ``head`` and lists the blocks
    with a dense SwiGLU ``ffn`` (``models.blocks.AttnBlock``) in
    :meth:`ffn_blocks`: none for the MoE and RWKV families, as the
    reference's quantize pass has no MLP route for them.
    """

    _head_q: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.head["w"].device

    def ffn_blocks(self):
        """The blocks whose SwiGLU FFN the quantized plan runs a16w8."""
        return []

    def input_specs(self, shape: ShapeSpec) -> InputSpecs:
        """The reference's ``input_specs``: the (shape, dtype) stand-ins of
        a step's inputs at ``shape``. A train or prefill shape takes tokens
        and labels [B, S]; a decode shape one token per sequence and its
        position (the dense, MoE, RWKV and hybrid families)."""
        if shape.kind in ("train", "prefill"):
            return token_input_specs(shape.global_batch, shape.seq_len)
        return decode_input_specs(shape.global_batch)

    def param_specs(self) -> Dict[str, ParamSpec]:
        """``{leaf key: ParamSpec}`` for every leaf of the reference's tree
        (``bridge.leaf_groups``), keyed by :func:`leaf_key`: the stacked
        shape (the group's stack, then the member's shape), the
        reference's logical axes under ``cfg.sharding_mode`` (one
        "layers" per stacked dim), the parameter's dtype and initialiser.
        Reads shapes only, so a model on the ``meta`` device serves."""
        from repro_torch.bridge import leaf_groups

        params = dict(self.named_parameters())
        out = {}
        for grp in leaf_groups(self):
            p = params[grp.members[0]]
            shape = grp.stack + tuple(p.shape)
            logical = (("layers",) * len(grp.stack)
                       + leaf_logical(grp.name, self.cfg.sharding_mode))
            init, _ = init_kind(grp.name, shape)
            # the reference's MoE weights carry their fan-in std explicitly
            scale = (1.0 / (shape[-2] ** 0.5)
                     if grp.name.split(".")[-2] == "moe" else None)
            out[leaf_key(grp.name)] = ParamSpec(shape, logical, p.dtype,
                                                init, scale)
        return out

    def mlp_down_weights(self):
        """Every ``ffn.down`` weight the a16w8 path quantizes (the
        reference's calibration walks each ``ffn/down`` leaf)."""
        return [blk.ffn["down"]["w"] for blk in self.ffn_blocks()]

    @torch.no_grad()
    def init_params(self, seed: int = 0):
        """Random parameters from a ``torch.Generator`` on the model's
        device, with the reference's initialisers (:func:`init_kind`). The
        stream differs from the reference's ``jax.random``; tests carry
        weights across with the bridge."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            kind, scale = init_kind(name, tuple(p.shape))
            if kind in ("zeros", "ones"):
                p.fill_(scale)
            else:
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=self.device) * scale)
        self.reset_quantized()
        return self

    def reset_quantized(self) -> None:
        """Drop the int8 weight copies; call after changing parameters."""
        self._head_q = None
        for blk in self.ffn_blocks():
            blk._down_q = None

    def quantized_head(self) -> torch.Tensor:
        """The LM head as int8 at the head's w_shift, made once."""
        if self._head_q is None:
            self._head_q = quantize_weight(self.head["w"], HEAD_SHIFTS[1])
        return self._head_q

    def head_logits(self, x: torch.Tensor, block: bool = False
                    ) -> torch.Tensor:
        """fp32 logits of decode hiddens: [B, V] from ``x`` [B, 1, d], or
        with ``block`` [B, m, V] from [B, m, d]; through qmatmul when
        ``cfg.quantized``."""
        head_q = self.quantized_head() if self.cfg.quantized else None
        fn = decode_block_head_logits if block else decode_head_logits
        return fn(self.head["w"], x, self.cfg, head_q)
