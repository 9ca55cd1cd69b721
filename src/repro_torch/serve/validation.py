"""Single source of truth for speculative/paged serve validation.

A stdlib-only copy of the reference's ``serve/validation.py``. Every
constraint on the speculative geometry lives here: ``ServeBatcher``
resolves the user-facing ``speculative=``/``draft=`` arguments through
:func:`resolve_speculative`, and ``ContinuousScheduler`` re-checks a
resolved tuple through :func:`validate_spec_geometry` /
:func:`validate_paged_spec` (it can be constructed directly, so it must
not trust its caller).

Speculative lanes are not ported yet: :func:`resolve_speculative` keeps
every check of the reference and then raises ``NotImplementedError`` for
a non-zero ``speculative`` (they need ``DecoderLM.decode_block``, the
block attention variants and the speculative branch of the scheduler).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

SPEC_NOT_PORTED = (
    "speculative decode lanes are not ported yet (ROADMAP: the speculative "
    "slice, next: DecoderLM.decode_block, the block and paged-block "
    "attention variants, the speculative branches of the masked step and "
    "the scheduler)")


def validate_spec_geometry(spec: Tuple[int, int],
                           steps_per_dispatch: int) -> None:
    """The invariants every resolved ``(spec_k, draft_layers)`` obeys."""
    spec_k, draft_layers = spec
    if spec_k != steps_per_dispatch:
        raise ValueError(
            f"spec_k ({spec_k}) must equal steps_per_dispatch "
            f"({steps_per_dispatch}): the draft proposes exactly one "
            "micro-run per dispatch")
    if draft_layers < 1:
        raise ValueError(
            f"draft_layers must be >= 1, got {draft_layers}")


def validate_paged_spec(spec: Tuple[int, int], paged: Tuple[int, int],
                        buckets: Sequence) -> None:
    """Speculative lanes over the page pool need headroom for draft
    leases: per live lane the allocator transiently holds up to
    ``ceil(spec_k / page_size) + 1`` revocable draft pages on top of the
    committed run. Require the pool to fully back at least one slot of
    every bucket plus that demand plus the per-lane scratch pages —
    otherwise a sole speculative lane could be unable to extend its
    lease and the dispatch could not make progress."""
    spec_k, _ = spec
    page_count, page_size = paged
    demand = -(-spec_k // page_size) + 1
    scratch = max(b.batch for b in buckets)
    for b in buckets:
        need = scratch + b.max_len // page_size + demand
        if page_count < need:
            raise ValueError(
                f"paged speculative decode needs page_count >= {need} "
                f"for bucket {b.label} (scratch {scratch} + "
                f"{b.max_len // page_size} slot pages + {demand} draft "
                f"lease pages), got {page_count}")


def resolve_speculative(speculative: int, draft: Optional[str], *,
                        schedule: str, steps_per_dispatch: int,
                        n_layers: int) -> Optional[Tuple[int, int]]:
    """Resolve the batcher's ``speculative=``/``draft=`` arguments.

    ``draft`` names the draft model — ``"prefix:N"`` runs the first N
    layers of the target as a self-speculative draft (default: half the
    stack). Raises ValueError on every invalid combination, with the
    reference's messages; returns None without ``speculative`` and raises
    ``NotImplementedError`` for a valid one (:data:`SPEC_NOT_PORTED`).
    """
    if draft is not None and not speculative:
        raise ValueError(
            "draft only applies with speculative decode (speculative > 0)")
    if not speculative:
        return None
    if schedule != "continuous":
        raise ValueError(
            "speculative decode needs schedule='continuous' — only "
            "the masked-decode micro-run has a draft feed lane")
    if speculative != steps_per_dispatch:
        raise ValueError(
            f"speculative ({speculative}) must equal "
            f"steps_per_dispatch ({steps_per_dispatch}): the draft "
            "proposes exactly one micro-run per dispatch")
    draft_layers = max(1, n_layers // 2)
    if draft is not None:
        dkind, _, depth = draft.partition(":")
        if dkind != "prefix" or not depth.isdigit():
            raise ValueError(f"draft must be 'prefix:N', got {draft!r}")
        draft_layers = int(depth)
    if not 1 <= draft_layers <= n_layers:
        raise ValueError(
            f"draft depth must be in [1, {n_layers}], got {draft_layers}")
    raise NotImplementedError(SPEC_NOT_PORTED)
