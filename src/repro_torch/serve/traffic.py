"""Synthetic many-user serving load, deterministic under one seed.

The serving claims this repo makes (continuous batching, micro-runs,
admission policies) only mean something under load shaped like real
traffic: requests do not arrive in tidy waves, lengths are heavy-tailed
(most chats are short, a few are very long), users carry priorities and
deadlines, and some hang up before the first token. ``generate_traffic``
produces exactly that, reproducibly:

* **Poisson arrivals** — i.i.d. exponential inter-arrival gaps at
  ``spec.rate`` requests per tick;
* **heavy-tailed lengths** — lognormal prompt lengths and Pareto output
  lengths, clipped to the serving bucket's bounds (the shapes production
  traces actually show: a short-request bulk and a long tail that ties
  up slots);
* **priority classes and tenants** — weighted priority sampling and
  uniform tenant assignment, feeding :class:`~repro_torch.serve.policy.
  PriorityPolicy`'s strict-priority-with-fairness admission;
* **deadlines** — each deadlined request must finish within
  ``slack x`` its minimal service time (slack drawn per request), the
  input to EDF admission and the goodput-under-deadline benchmark
  headline;
* **abandonment** — a fraction of users lose patience and disconnect if
  the first token hasn't arrived within their patience window — the
  async server maps that to boundary-time cancellation;
* **shared system prompts** — with ``shared_prefix_prob`` a request opens
  with the trace's common ``shared_prefix_len``-token prefix, so the SAME
  trace can race admission policies on dense state and prefix-cache reuse
  on the paged pool.

The time unit is an abstract **tick**. A virtual-time replay runs
ticks as scheduler steps (virtual time: deterministic, CI-safe); the
async server replays them as scaled wall-clock seconds. Deadlines and
patience are absolute tick values on the same axis as ``at``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.batcher import DecodeRequest


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One arrival: when it lands, what it asks, when the user walks."""

    at: float                      # arrival tick
    request: DecodeRequest         # deadline (if any) is absolute, in ticks
    patience: Optional[float] = None   # abandon if no first token by this tick

    @property
    def min_service_ticks(self) -> int:
        """Steps a dedicated slot needs: prompt feed + decode - 1."""
        return len(self.request.prompt) + self.request.max_new_tokens - 1


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Knobs for one synthetic load shape (all distributions seeded)."""

    rate: float = 0.5              # mean arrivals per tick (Poisson)
    # heavy-tailed lengths: lognormal prompts, Pareto outputs
    prompt_log_mean: float = 1.1   # exp(1.1) ~ 3-token median prompt
    prompt_log_sigma: float = 0.8
    max_prompt: int = 24
    output_pareto_shape: float = 1.6   # smaller = heavier tail
    output_scale: float = 4.0
    max_new_tokens: int = 24
    vocab: int = 64                # token ids drawn from [1, vocab)
    # priority classes (value, weight); lower value = more urgent
    priorities: Tuple[Tuple[int, float], ...] = ((0, 0.2), (1, 0.3),
                                                 (2, 0.5))
    n_tenants: int = 4
    # deadlines: finish within slack x minimal service time of arrival
    deadline_prob: float = 1.0
    deadline_slack: Tuple[float, float] = (1.5, 6.0)
    # abandonment: disconnect if no first token within the patience window
    abandon_prob: float = 0.0
    patience_mean: float = 30.0
    # shared system prompt: with probability ``shared_prefix_prob`` a
    # request opens with the SAME ``shared_prefix_len`` tokens (drawn once
    # per trace) — the load shape that makes paged prefix reuse matter.
    # Align the length to the page size (16) for full-page prefix hits.
    shared_prefix_len: int = 0
    shared_prefix_prob: float = 0.0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.shared_prefix_len < 0:
            raise ValueError("shared_prefix_len must be >= 0")
        if not 0 <= self.shared_prefix_prob <= 1:
            raise ValueError("shared_prefix_prob must be in [0, 1]")
        if not 0 <= self.deadline_prob <= 1:
            raise ValueError("deadline_prob must be in [0, 1]")
        if not 0 <= self.abandon_prob <= 1:
            raise ValueError("abandon_prob must be in [0, 1]")
        if abs(sum(w for _, w in self.priorities) - 1.0) > 1e-6:
            raise ValueError("priority weights must sum to 1")


def generate_traffic(spec: TrafficSpec, n: int, seed: int,
                     tag: str = "t") -> List[TrafficRequest]:
    """``n`` arrivals under ``spec``, bit-identical for the same seed."""
    rng = np.random.default_rng(seed)
    values = [p for p, _ in spec.priorities]
    weights = [w for _, w in spec.priorities]
    # the shared system prompt is drawn ONCE per trace (seed-stable); the
    # branch keeps prefix-free specs bit-identical to their old streams
    prefix: List[int] = []
    if spec.shared_prefix_len:
        prefix = [int(x) for x in rng.integers(
            1, spec.vocab, size=spec.shared_prefix_len)]
    out: List[TrafficRequest] = []
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(1.0 / spec.rate))
        plen = int(np.clip(round(rng.lognormal(
            spec.prompt_log_mean, spec.prompt_log_sigma)), 1,
            spec.max_prompt))
        new = int(np.clip(1 + round(rng.pareto(spec.output_pareto_shape)
                                    * spec.output_scale), 1,
                          spec.max_new_tokens))
        prompt = [int(x) for x in rng.integers(1, spec.vocab, size=plen)]
        if prefix and rng.random() < spec.shared_prefix_prob:
            prompt = prefix + prompt
        priority = int(rng.choice(values, p=weights))
        tenant = f"tenant{int(rng.integers(spec.n_tenants))}"
        min_service = len(prompt) + new - 1
        deadline = None
        if rng.random() < spec.deadline_prob:
            slack = float(rng.uniform(*spec.deadline_slack))
            deadline = t + slack * min_service
        patience = None
        if rng.random() < spec.abandon_prob:
            patience = t + float(rng.exponential(spec.patience_mean))
        out.append(TrafficRequest(
            at=t,
            request=DecodeRequest(
                f"{tag}{i}", prompt, max_new_tokens=new,
                priority=priority, tenant=tenant, deadline=deadline),
            patience=patience,
        ))
    return out


def summarize(trace: Sequence[TrafficRequest]) -> dict:
    """Shape-of-load digest recorded next to benchmark numbers."""
    if not trace:
        return {"requests": 0}
    plens = [len(tr.request.prompt) for tr in trace]
    news = [tr.request.max_new_tokens for tr in trace]
    # longest prompt prefix shared by the largest same-first-token group:
    # >= a page (16 tokens) across many requests means paged prefix
    # reuse has something to hit on this trace
    prompts = [list(tr.request.prompt) for tr in trace]
    groups: dict = {}
    for p in prompts:
        groups.setdefault(p[0], []).append(p)
    biggest = max(groups.values(), key=len)
    shared_len = 0
    if len(biggest) >= 2:
        shared_len = min(len(p) for p in biggest)
        for j in range(shared_len):
            if len({p[j] for p in biggest}) > 1:
                shared_len = j
                break
    return {
        "requests": len(trace),
        "span_ticks": round(trace[-1].at, 2),
        "prompt_len": {"p50": int(np.median(plens)), "max": max(plens)},
        "new_tokens": {"p50": int(np.median(news)), "max": max(news)},
        "shared_prefix": {"len": shared_len,
                          "requests": len(biggest) if shared_len else 0},
        "deadlined": sum(tr.request.deadline is not None for tr in trace),
        "abandoning": sum(tr.patience is not None for tr in trace),
        "priorities": {
            str(p): sum(tr.request.priority == p for tr in trace)
            for p in sorted({tr.request.priority for tr in trace})},
    }
