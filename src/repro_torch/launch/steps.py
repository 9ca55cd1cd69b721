"""Step functions shared by the plan and the serving batcher.

Each ``make_*`` returns a plain function whose first argument is the model
(the reference's executables took the parameter tree there). Nothing is
traced or compiled: a step runs eagerly on the model's device, and a
"build" is binding the step to its shapes. Steps check their inputs'
shapes against the shapes they were built for. On a sharded model
(``ExecutionPlan.activate``) the serve steps run under ``torch.no_grad``
instead of inference mode, and the tokens they return are plain tensors
(``dist.sharding.local_value``), which the host reads as it always has.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.dist.sharding import local_value, serving
from repro_torch.models.base import (
    ArchConfig,
    PageView,
    ShapeSpec,
    prefill_inputs,
    split_spec_state,
    state_batch_axes,
    train_inputs,
    wipe_state_slots,
)
from repro_torch.serve.validation import validate_spec_geometry

Step = Callable[..., object]


def _expect(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, this step was "
                         f"built for {tuple(shape)}")


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec) -> Step:
    """``prefill(model, batch) -> logits [B, S_dec, V]`` fp32, the batch
    holding the family's inputs at this shape (``prefill_inputs``:
    ``tokens`` [B, S], plus ``frames`` for the encoder-decoder, whose
    decoder runs ``max(S // dec_ratio, 128)`` tokens, or ``vision`` for
    the vision LM)."""
    want = {name: s for name, (s, _) in prefill_inputs(cfg, shape).items()}

    def prefill_step(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if set(batch) != set(want):
            raise ValueError(f"prefill batch has {sorted(batch)}, this step "
                             f"was built for {sorted(want)}")
        for name, s in want.items():
            _expect(name, batch[name], s)
        return model.forward(batch)

    return prefill_step


def make_train_step(cfg: ArchConfig, shape: ShapeSpec, optimizer,
                    mesh=None, rules=None) -> Step:
    """``train(model, opt_state, batch) -> {"loss", "grad_norm"}``: one
    optimizer step on ``batch`` (``train_inputs`` at this shape), the
    parameters and ``opt_state`` updated in place (the reference returned
    new ones), with ``cfg.microbatches`` accumulated microbatches
    (``train.trainer.train_step``). With ``mesh`` (and ``rules``) the step
    runs sharded on it: the model's parameters and the state are DTensors
    there, and the batch is laid out over the data axes."""
    from repro_torch.train.trainer import train_step as step

    want = train_inputs(cfg, shape)
    nmb = max(1, cfg.microbatches)

    def train_step(model, opt_state, batch: Dict[str, torch.Tensor]):
        if set(batch) != set(want):
            raise ValueError(f"train batch has {sorted(batch)}, this step "
                             f"was built for {sorted(want)}")
        for name, s in want.items():
            _expect(name, batch[name], s)
        return step(model, optimizer, opt_state, batch, microbatches=nmb,
                    mesh=mesh, rules=rules)

    return train_step


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

    @serving
    def prefill_decode(model, state, prompt: torch.Tensor,
                       lengths: torch.Tensor):
        _expect("prompt", prompt, (batch, prefill_len))
        _expect("lengths", lengths, (batch,))
        prev = prompt[:, 0]
        toks = []
        for i in range(prefill_len):
            tok = torch.where(i < lengths, prompt[:, i], prev)
            logits, state = model.decode_step(state, tok, i)
            prev = local_value(torch.argmax(logits, dim=-1)).to(torch.int32)
            toks.append(prev)
        return torch.stack(toks, dim=1), state

    return prefill_decode


def make_masked_decode_step(cfg: ArchConfig, batch: int, max_len: int, *,
                            steps_per_dispatch: int = 1,
                            paged: Optional[Tuple[int, int]] = None,
                            spec: Optional[Tuple[int, int]] = None) -> Step:
    """Slot-masked decode micro-run for continuous batching: one step per
    (bucket, k), whose shapes never change under churn.

    Every batch lane ("slot") may be at a different point of a request's
    life. The per-slot control lanes are ``[k, batch]`` schedules the host
    precomputes for the whole micro-run of k = ``steps_per_dispatch``
    masked steps:

    * ``fresh[i, b]`` — slot ``b`` is (re)admitted: its batch-laned state
      is zeroed before anything reads it. Admission lands on micro-run
      boundaries, so only row 0 may be set, and the wipe runs once, before
      the k steps;
    * ``start[i, b]`` — the global position the slot's request began at;
      attention is windowed to ``[start[i, b], pos + i]`` (RoPE scores
      depend only on relative position, so a request admitted at position
      37 decodes as it would from 0);
    * ``feed[i, b]`` — teacher forcing for chunked prefill: ``>= 0`` feeds
      this prompt token, ``-1`` continues from the slot's previous argmax;
    * ``active[i, b]`` — a slot whose request ends mid-run self-masks for
      the remaining steps and emits token 0 (never read).

    With ``paged=(page_count, page_size)`` the KV leaves are the shared
    page pool and the step takes a ninth input, ``table`` [batch,
    max_len // page_size] int32: attention then reads and writes at each
    slot's LOCAL position ``pos + i - start[i, b]`` through its table, so
    ``start`` may sit before the admission boundary when a prompt prefix
    came from the prefix cache. The fresh wipe skips the pool leaves.

    With ``spec=(spec_k, draft_layers)`` (``spec_k`` must equal k) the
    micro-run is a speculative dispatch. The first ``draft_layers`` blocks
    of the model (shared embedding, final norm and head; no second
    parameter set) draft k tokens with ``decode_block(m=1)``, chaining
    their own argmax through the feed lane, on the ``draft_`` half of the
    state; then the whole model scores the k consumed tokens in ONE
    teacher-forced ``decode_block`` over the same positions. Both index at
    each slot's local position ``pos + i - start[0, b]``, which makes a
    host-side rollback a bump of the slot's start: rejected rows sit at
    or above the rewound cursor, where the next block overwrites them
    before any mask admits them. Paged, the draft's KV twins live in their
    own pool with the same page axes and both index through the slot's
    one page table.

    ``masked(model, state, feed [k,B], prev [B], pos, start [k,B],
    active [k,B], fresh [k,B] [, table]) -> (toks [k,B] int32, last [B]
    int32, state)``: ``pos`` is the micro-run's base position (a host
    int), ``prev`` the previous micro-run's ``last``. Speculative mode
    returns ``(verify [k,B], drafts [k,B], state)`` instead, the target's
    greedy token after each consumed position and the draft's proposals,
    both 0 on inactive lane-steps; its ``prev`` is the last committed
    token of each slot, which the host rebuilds at every boundary. The
    state is written in place. The steps are a Python loop of device work:
    nothing in it reads a tensor back to the host.
    """
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    k = steps_per_dispatch
    if spec is not None:
        validate_spec_geometry(spec, k)
        draft_layers = spec[1]
        if draft_layers > cfg.n_layers:
            raise ValueError(
                f"draft_layers must be in [1, {cfg.n_layers}], "
                f"got {draft_layers}")
    sched = (k, batch)
    n_tables = page_size = 0
    if paged is not None:
        page_count, page_size = paged
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        n_tables = max_len // page_size

    @serving
    def masked_decode(model, state, feed: torch.Tensor, prev: torch.Tensor,
                      pos: int, start: torch.Tensor, active: torch.Tensor,
                      fresh: torch.Tensor,
                      table: Optional[torch.Tensor] = None):
        for name, t in (("feed", feed), ("start", start), ("active", active),
                        ("fresh", fresh)):
            _expect(name, t, sched)
        _expect("prev", prev, (batch,))
        if (table is None) != (paged is None):
            raise ValueError("a paged step takes a page table, a dense "
                             "step none")
        if paged is not None:
            _expect("table", table, (batch, n_tables))
        if not 0 <= pos <= max_len - k:
            raise ValueError(f"micro-run [{pos}, {pos + k}) outside the "
                             f"bucket's {max_len} positions")
        wipe_state_slots(state, fresh[0],
                         state_batch_axes(state, paged is not None))
        if spec is not None:
            return spec_run(model, state, feed, prev, pos, start, active,
                            table)
        toks = []
        last = prev
        for i in range(k):
            tok_in = torch.where(feed[i] >= 0, feed[i], last)
            if paged is not None:
                pages = PageView(table, pos + i - start[i], page_size)
                logits, state = model.decode_step(state, tok_in, pos + i,
                                                  pages=pages)
            else:
                logits, state = model.decode_step(state, tok_in, pos + i,
                                                  window_start=start[i])
            # a masked lane emits 0; a slot live at the next micro-run is
            # active at step k-1, so ``last`` is always a valid next prev
            tok = local_value(torch.argmax(logits, dim=-1))
            last = torch.where(active[i], tok.to(torch.int32), 0)
            toks.append(last)
        return torch.stack(toks), last, state

    def spec_run(model, state, feed, prev, pos, start, active, table):
        tstate, dstate = split_spec_state(state)
        local0 = pos - start[0]                         # [B] per slot

        def view(local):
            return (PageView(table, local, page_size) if paged is not None
                    else None)

        tok_ins, drafts = [], []
        last = prev
        for i in range(k):
            tok_in = torch.where(feed[i] >= 0, feed[i], last)
            logits, _ = model.decode_block(
                dstate, tok_in[:, None], local0 + i, pages=view(local0 + i),
                n_layers=draft_layers)
            last = local_value(torch.argmax(logits[:, 0], dim=-1)).to(
                torch.int32)
            tok_ins.append(tok_in)
            drafts.append(last)
        # one teacher-forced pass of the whole model over the k tokens the
        # draft consumed (prompt feeds included, so both caches hold the
        # same token prefix)
        logits, _ = model.decode_block(tstate, torch.stack(tok_ins, dim=1),
                                       local0, pages=view(local0))
        verify = local_value(torch.argmax(logits, dim=-1)).to(
            torch.int32).T                                          # [k, B]
        return (torch.where(active, verify, 0),
                torch.where(active, torch.stack(drafts), 0), state)

    return masked_decode

