"""Step functions shared by the plan and the serving batcher.

Each ``make_*`` returns a plain function whose first argument is the model
(the reference's executables took the parameter tree there). Nothing is
traced or compiled: a step runs eagerly on the model's device, and a
"build" is binding the step to its shapes. Steps check their inputs'
shapes against the shapes they were built for.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.base import ArchConfig, ShapeSpec

Step = Callable[..., object]


def _expect(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, this step was "
                         f"built for {tuple(shape)}")


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec) -> Step:
    """``prefill(model, {"tokens": [B, S]}) -> logits [B, S, V]`` fp32."""
    want = (shape.global_batch, shape.seq_len)

    def prefill_step(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _expect("tokens", batch["tokens"], want)
        return model.forward(batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: ShapeSpec) -> Step:
    """Decode step: one new token per sequence against resident state.

    ``serve(model, state, tokens [B], pos) -> (logits [B, V], state)``; the
    state's KV cache is updated in place.
    """
    batch = shape.global_batch

    def serve_step(model, state, tokens: torch.Tensor, pos: int):
        _expect("tokens", tokens, (batch,))
        return model.decode_step(state, tokens, pos)

    return serve_step


def make_prefill_decode_step(cfg: ArchConfig, batch: int, prefill_len: int,
                             max_len: int) -> Step:
    """Batched prefill that hands off to decode: loop ``decode_step`` over a
    right-padded prompt block, teacher-forcing each sequence's prompt
    tokens and switching to greedy generation the moment its prompt runs
    out. No pad token ever enters the cache, and the returned state is
    ready for the single-token step at position ``prefill_len``.

    ``prefill_decode(model, state, prompt [B, P] int, lengths [B] int >= 1)
    -> (tokens [B, P] int32, state)``: ``tokens[b, i]`` is the greedy
    prediction for position ``i + 1``; entries at ``i >= lengths[b] - 1``
    are generated tokens, earlier ones teacher-forced prompt echoes.
    """
    if prefill_len > max_len:
        raise ValueError(f"prefill_len {prefill_len} exceeds max_len "
                         f"{max_len}")

    @torch.inference_mode()
    def prefill_decode(model, state, prompt: torch.Tensor,
                       lengths: torch.Tensor):
        _expect("prompt", prompt, (batch, prefill_len))
        _expect("lengths", lengths, (batch,))
        prev = prompt[:, 0]
        toks = []
        for i in range(prefill_len):
            tok = torch.where(i < lengths, prompt[:, i], prev)
            logits, state = model.decode_step(state, tok, i)
            prev = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(prev)
        return torch.stack(toks, dim=1), state

    return prefill_decode

